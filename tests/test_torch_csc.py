"""The port's CSC host format and `spgemm_csr_csc` against the JAX
package's: the same arrays from the same dense matrices and CSRs, and
round trips through dense."""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

import repro.sparse as r_sparse
from repro.sparse.ref_spgemm import spgemm_csr_csc as r_spgemm_csr_csc

from repro_torch.sparse import (
    CSC, CSR, csc_from_dense, csc_to_dense, csr_from_dense, csr_to_csc,
    csr_to_dense, spgemm_csr_csc,
)

CASES = [(1, 1, 1.0, 0), (7, 5, 0.3, 1), (16, 24, 0.1, 2), (33, 9, 0.0, 3),
         (40, 40, 0.05, 4)]


def _dense(n, m, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.standard_normal((n, m))).astype(dtype)


def _same_arrays(p, r):
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f))
        assert getattr(p, f).dtype == getattr(r, f).dtype, f
    assert tuple(p.shape) == tuple(r.shape)


@pytest.mark.parametrize("n,m,density,seed", CASES)
def test_csc_from_dense_matches_reference_and_round_trips(n, m, density,
                                                          seed):
    d = _dense(n, m, density, seed)
    p, r = csc_from_dense(d), r_sparse.csc_from_dense(d)
    assert isinstance(p, CSC)
    _same_arrays(p, r)
    assert p.nnz == r.nnz == int(np.count_nonzero(d))
    assert p.nbytes() == r.nbytes() and p.nbytes(8) == r.nbytes(8)
    np.testing.assert_array_equal(csc_to_dense(p), d)
    np.testing.assert_array_equal(csc_to_dense(p), r_sparse.csc_to_dense(r))


@pytest.mark.parametrize("n,m,density,seed", CASES)
def test_csr_to_csc_matches_reference(n, m, density, seed):
    d = _dense(n, m, density, seed)
    p_csr, r_csr = csr_from_dense(d), r_sparse.csr_from_dense(d)
    p, r = csr_to_csc(p_csr), r_sparse.csr_to_csc(r_csr)
    _same_arrays(p, r)
    np.testing.assert_array_equal(csc_to_dense(p), d)
    # CSC of A is CSR of Aᵀ, array for array.
    _same_arrays(p, CSC(*(getattr(csc_from_dense(d), f)
                          for f in ("indptr", "indices", "data")), d.shape))
    np.testing.assert_array_equal(p_csr.row_nnz(), r_csr.row_nnz())
    np.testing.assert_array_equal(p_csr.row_nnz(),
                                  np.count_nonzero(d, axis=1))


@pytest.mark.parametrize("k", [1, 6, 13])
@pytest.mark.parametrize("n,m,density,seed", CASES)
def test_spgemm_csr_csc_matches_reference(n, m, density, seed, k):
    a = _dense(n, m, density, seed)
    b = _dense(m, k, 0.4, seed + 100)
    got = spgemm_csr_csc(csr_from_dense(a), csc_from_dense(b))
    want = r_spgemm_csr_csc(r_sparse.csr_from_dense(a),
                            r_sparse.csc_from_dense(b))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, a @ b, rtol=1e-5, atol=1e-6)


def test_row_nnz_of_a_port_csr():
    p = CSR(np.array([0, 2, 2, 5]), np.array([0, 1, 0, 1, 2]),
            np.ones(5, np.float32), (3, 3))
    np.testing.assert_array_equal(p.row_nnz(), [2, 0, 3])
    np.testing.assert_array_equal(csr_to_dense(p).sum(axis=1), [2, 0, 3])
