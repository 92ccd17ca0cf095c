"""Exact parity of the port's host-side modules with the JAX package's:
the same seeded inputs give array-equal graphs, fingerprints, bricks, RoBW
plans and memory plans."""
import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.core.memory_model as r_mm
import repro.core.robw as r_robw
import repro.data.graphs as r_graphs
import repro.sparse.blocking as r_blocking
import repro.sparse.formats as r_formats
import repro_torch.core.memory_model as p_mm
import repro_torch.core.robw as p_robw
import repro_torch.data.graphs as p_graphs
import repro_torch.sparse.blocking as p_blocking
import repro_torch.sparse.formats as p_formats

GRAPHS = [("socLJ1", 1e-4, 0), ("rUSA", 1e-4, 1), ("kV2a", 2e-4, 3),
          ("socLJ1", 3e-4, 2), ("rUSA", 2e-5, 1)]


def _csr_equal(p, r):
    assert p.shape == r.shape
    for name in ("indptr", "indices", "data"):
        a, b = getattr(p, name), getattr(r, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _ell_equal(p, r):
    assert (p.bm, p.bk, p.n_rows, p.n_cols) == (r.bm, r.bk, r.n_rows, r.n_cols)
    for name in ("blocks", "col_tile", "n_tiles"):
        a, b = getattr(p, name), getattr(r, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _graph_pair(name, scale, seed):
    p = p_graphs.generate_graph(
        p_graphs.scaled_spec(p_graphs.SUITESPARSE_SPECS[name], scale), seed)
    r = r_graphs.generate_graph(
        r_graphs.scaled_spec(r_graphs.SUITESPARSE_SPECS[name], scale), seed)
    return p, r


def _to_port(r):
    return p_formats.CSR(r.indptr.copy(), r.indices.copy(), r.data.copy(),
                         r.shape)


def _sparse(n, m, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.standard_normal((n, m))).astype(dtype)


@pytest.mark.parametrize("name,scale,seed", GRAPHS)
def test_generated_and_normalized_graphs_are_array_equal(name, scale, seed):
    p, r = _graph_pair(name, scale, seed)
    _csr_equal(p, r)
    pn, rn = p_graphs.normalized_adjacency(p), r_graphs.normalized_adjacency(r)
    _csr_equal(pn, rn)
    assert p_formats.csr_fingerprint(pn) == r_formats.csr_fingerprint(rn)
    assert p_formats.graph_cache_prefix(pn) == r_formats.graph_cache_prefix(rn)


def test_normalized_adjacency_keeps_the_reference_row_rule():
    """Rows holding a self-loop keep their (unsorted) column order; rows
    lacking one get it inserted and are sorted."""
    indptr = np.array([0, 3, 5, 5, 8], np.int64)
    indices = np.array([2, 0, 1, 3, 0, 3, 2, 0], np.int64)
    data = np.arange(1, 9, dtype=np.float32)
    r = r_formats.CSR(indptr, indices, data, (4, 4))
    _csr_equal(p_graphs.normalized_adjacency(_to_port(r)),
               r_graphs.normalized_adjacency(r))


@pytest.mark.parametrize("name,scale,seed", GRAPHS[:3])
def test_segment_fingerprints_transpose_and_slices(name, scale, seed):
    p, r = _graph_pair(name, scale, seed)
    n = p.n_rows
    for lo, hi in [(0, n), (0, 1), (3, n // 2), (n // 3, n - 1)]:
        assert (p_formats.segment_fingerprint(p, lo, hi)
                == r_formats.segment_fingerprint(r, lo, hi))
        _csr_equal(p_formats.csr_row_slice(p, lo, hi),
                   r_formats.csr_row_slice(r, lo, hi))
    _csr_equal(p_formats.csr_transpose(p), r_formats.csr_transpose(r))


@pytest.mark.parametrize("n,m,density", [(16, 16, 0.3), (40, 24, 0.05),
                                         (33, 57, 0.3), (1, 9, 0.5),
                                         (64, 200, 0.02), (24, 24, 0.0)])
def test_dense_round_trip(n, m, density):
    dense = _sparse(n, m, density, seed=n + m)
    p, r = p_formats.csr_from_dense(dense), r_formats.csr_from_dense(dense)
    _csr_equal(p, r)
    np.testing.assert_array_equal(p_formats.csr_to_dense(p),
                                  r_formats.csr_to_dense(r))


@pytest.mark.parametrize("n,m,density,bm,bk,width,dtype", [
    (16, 16, 0.3, 8, 8, None, np.float32),
    (40, 24, 0.05, 8, 8, None, np.float32),
    (64, 64, 0.3, 8, 8, None, np.float32),
    (33, 57, 0.3, 8, 8, None, np.float32),
    (33, 57, 0.3, 8, 8, 2, np.float32),        # truncation: keep busiest
    (70, 300, 0.1, 16, 8, 3, np.float32),
    (50, 70, 0.2, 12, 8, None, np.float16),
    (96, 96, 0.1, 16, 32, None, np.float32),
    (24, 24, 0.0, 8, 8, None, np.float32),     # no nonzeros at all
    (5, 3, 0.6, 8, 8, 4, np.float32),          # ell_width above tile count
])
def test_tile_csr_to_block_ell_is_array_equal(n, m, density, bm, bk, width,
                                              dtype):
    dense = _sparse(n, m, density, seed=7 * n + m)
    r = r_formats.csr_from_dense(dense)
    pe = p_blocking.tile_csr_to_block_ell(_to_port(r), bm=bm, bk=bk,
                                          ell_width=width, dtype=dtype)
    re = r_blocking.tile_csr_to_block_ell(r, bm=bm, bk=bk, ell_width=width,
                                          dtype=dtype)
    _ell_equal(pe, re)
    np.testing.assert_array_equal(p_blocking.block_ell_to_dense(pe),
                                  r_blocking.block_ell_to_dense(re))


@pytest.mark.parametrize("name,scale,seed", GRAPHS)
@pytest.mark.parametrize("width", [64, 256])
def test_memory_plan_robw_plan_and_bricks_are_equal(name, scale, seed, width):
    p, r = _graph_pair(name, scale, seed)
    p, r = p_graphs.normalized_adjacency(p), r_graphs.normalized_adjacency(r)
    pm = p_mm.plan_memory_dense_features(p, p.n_rows, width, float("inf"))
    rm = r_mm.plan_memory_dense_features(r, r.n_rows, width, float("inf"))
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    budget = int(rm.m_b + rm.m_c + 0.6 * r.nbytes())
    feat = (p.n_rows, width)
    pu = p_mm.plan_memory_unified(p, p_mm.FeatureSpec(*feat), budget)
    ru = r_mm.plan_memory_unified(r, r_mm.FeatureSpec(*feat), budget)
    assert dataclasses.asdict(pu) == dataclasses.asdict(ru)
    assert pu.m_a == ru.m_a
    for align in (1, 8):
        pp = p_robw.robw_partition(p, int(pu.m_a), align=align)
        rp = r_robw.robw_partition(r, int(ru.m_a), align=align)
        assert ([dataclasses.astuple(s) for s in pp.segments]
                == [dataclasses.astuple(s) for s in rp.segments])
        assert (pp.align, pp.budget_bytes) == (rp.align, rp.budget_bytes)
    assert len(pp.segments) >= 2
    for pe, re in zip(p_robw.segments_to_block_ell(p, pp, bm=8, bk=8),
                      r_robw.segments_to_block_ell(r, rp, bm=8, bk=8)):
        _ell_equal(pe, re)
    pt, ptp = p_robw.robw_transpose_plan(p, int(pu.m_a), align=8)
    rt, rtp = r_robw.robw_transpose_plan(r, int(ru.m_a), align=8)
    _csr_equal(pt, rt)
    assert ([dataclasses.astuple(s) for s in ptp.segments]
            == [dataclasses.astuple(s) for s in rtp.segments])


def test_memory_model_scalar_functions_agree():
    for k, q in [(0, 0), (1, 5), (1000, 12345)]:
        assert p_mm.calc_mem(k, q) == r_mm.calc_mem(k, q)
        assert p_mm.calc_mem(k, q, 2, 8) == r_mm.calc_mem(k, q, 2, 8)
    for w in [0, 1, 2, 3, 5, 64, 65, 1000]:
        assert p_mm.ell_bucket_capacity(w) == r_mm.ell_bucket_capacity(w)
        assert (p_mm.ell_bucket_capacity(w, [4, 16, 2048])
                == r_mm.ell_bucket_capacity(w, [4, 16, 2048]))
    with pytest.raises(ValueError):
        p_mm.ell_bucket_capacity(9, [2, 8])
    args = (1e6, 2e5, 99.9, 99.0)
    assert p_mm.estimate_output_bytes(*args) == r_mm.estimate_output_bytes(*args)
    spec = (100, 16, 4, 99.0)
    assert (dataclasses.asdict(p_mm.FeatureSpec(*spec))
            == dataclasses.asdict(r_mm.FeatureSpec(*spec)))
    assert (p_mm.FeatureSpec(*spec).compressed_bytes
            == r_mm.FeatureSpec(*spec).compressed_bytes)
