"""Reference SpMM oracles (numpy and torch): the ground truth the stream
and the kernels are tested against."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.formats import CSC, CSR, csc_to_dense, csr_to_dense


def spgemm_csr_dense(a: CSR, h: np.ndarray) -> np.ndarray:
    """X = A @ H with CSR A, dense H — row-by-row gather-accumulate.

    This is the semantic the paper's SpGEMM computes for aggregation (Eq. 1).
    """
    n_rows = a.shape[0]
    out = np.zeros((n_rows, h.shape[1]),
                   dtype=np.result_type(a.data.dtype, h.dtype))
    for i in range(n_rows):
        lo, hi = a.indptr[i], a.indptr[i + 1]
        if hi > lo:
            out[i] = a.data[lo:hi] @ h[a.indices[lo:hi]]
    return out


def spgemm_csr_csc(a: CSR, b: CSC) -> np.ndarray:
    """C = A @ B with both operands compressed (paper's general case)."""
    return csr_to_dense(a) @ csc_to_dense(b)


def spmm_dense_ref(a_dense: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Dense torch oracle: A @ H accumulated in float32."""
    return torch.matmul(a_dense.to(torch.float32), h.to(torch.float32))
