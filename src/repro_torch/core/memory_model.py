"""AIRES analytical memory model — paper Eq. (5), (6), (7).

The model answers, *before any data is loaded* (paper §III-B last paragraph):
given device memory M, how much must be reserved for the resident matrix B
(M_B, Eq. 6) and the output C (M_C, Eq. 5), and what per-segment budget p
remains for streaming CSR A (Eq. 7)?

The same model also chooses the BlockELL *bucket capacity* (ell_width):
segments pad to a power-of-two tile width, so bricks are sized by capacity
planning instead of the paper's `cudaMalloc`-style dynamic allocation.
A copy of `repro.core.memory_model`; the tests hold the plans equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.sparse.formats import CSR


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Shape/sparsity proxy for the feature matrix H (paper's CSC B).

    The paper trains with F=256 at 99% *uniform* sparsity (§V-A), stored
    compressed — simulate-mode schedulers only need this proxy, never the
    values. sparsity_pct=0 models dense device-resident features.
    """

    n_rows: int
    n_cols: int
    dtype_bytes: int = 4
    sparsity_pct: float = 0.0
    index_bytes: int = 4

    @property
    def dense_bytes(self) -> int:
        return self.n_rows * self.n_cols * self.dtype_bytes

    @property
    def nnz(self) -> int:
        return int(self.dense_bytes / self.dtype_bytes
                   * (100.0 - self.sparsity_pct) / 100.0)

    @property
    def value_bytes(self) -> int:
        """α_B of Eq. (5)/(6)."""
        return self.nnz * self.dtype_bytes

    @property
    def compressed_bytes(self) -> int:
        """M_B of Eq. (6): values + column ids + row pointers."""
        if self.sparsity_pct <= 0.0:
            return self.dense_bytes
        return (self.value_bytes + self.nnz * self.index_bytes
                + (self.n_cols + 1) * self.index_bytes)

    @classmethod
    def of(cls, h) -> "FeatureSpec":
        """Accept a FeatureSpec, a numpy array, or (n, f) tuple."""
        if isinstance(h, cls):
            return h
        if hasattr(h, "shape") and hasattr(h, "dtype"):
            return cls(h.shape[0], h.shape[1], h.dtype.itemsize, 0.0)
        n, f = h
        return cls(n, f)


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    m_b: float          # bytes reserved for resident matrix B (Eq. 6)
    m_c: float          # bytes reserved for output C (Eq. 5)
    p: float            # per-segment byte budget for streamed CSR A (Eq. 7)
    m_total: float      # device budget
    feasible: bool      # p > 0 — can the schedule run at all?

    @property
    def m_a(self) -> float:
        return self.p * 3.0  # Eq. 7 inverted: segment budget covers 3 arrays


def estimate_output_bytes(
    alpha_a: float,
    alpha_b: float,
    sparsity_a_pct: float,
    sparsity_b_pct: float,
) -> float:
    """Eq. (5): M_C = 3·α_A·(100−s_A)/100 · (1 + α_B/α_A + (100−s_B)/100).

    α = value-array byte size of the compressed matrix, s = sparsity %.
    The leading 3 models CSR C's three arrays (values/indices/indptr).
    """
    dens_a = (100.0 - sparsity_a_pct) / 100.0
    dens_b = (100.0 - sparsity_b_pct) / 100.0
    return 3.0 * alpha_a * dens_a * (1.0 + alpha_b / max(alpha_a, 1.0) + dens_b)


def estimate_resident_bytes(alpha_b: float, beta_b: float, theta_b: float) -> float:
    """Eq. (6): M_B = α_B + β_B + θ_B (values + column ids + row ids)."""
    return alpha_b + beta_b + theta_b


def segment_budget(m_total: float, m_c: float, m_b: float) -> float:
    """Eq. (7): p = (M − M_C − M_B) / 3."""
    return (m_total - m_c - m_b) / 3.0


def plan_memory(
    a: CSR,
    b_nbytes_values: float,
    b_nbytes_colid: float,
    b_nbytes_rowid: float,
    m_total: float,
    sparsity_b_pct: float = 99.0,
    index_bytes: int = 4,
) -> MemoryEstimate:
    """Run Eq. 5–7 for a concrete (A, B, budget) triple."""
    alpha_a = float(a.nnz * a.data.dtype.itemsize)
    n_total = float(a.shape[0]) * float(a.shape[1])
    sparsity_a_pct = 100.0 * (1.0 - a.nnz / max(n_total, 1.0))
    alpha_b = float(b_nbytes_values)
    m_c = estimate_output_bytes(alpha_a, alpha_b, sparsity_a_pct, sparsity_b_pct)
    m_b = estimate_resident_bytes(alpha_b, b_nbytes_colid, b_nbytes_rowid)
    p = segment_budget(m_total, m_c, m_b)
    return MemoryEstimate(m_b=m_b, m_c=m_c, p=p, m_total=m_total,
                          feasible=p > 0.0)


def plan_memory_unified(
    a: CSR,
    feat,
    m_total: float,
    index_bytes: int = 4,
) -> MemoryEstimate:
    """THE Eq. 5-7 planner — single reading for compressed AND dense features.

    `feat` is anything `FeatureSpec.of` accepts. α_A/α_B enter Eq. 5 as the
    DENSE value-array sizes, so α_A·(100−s_A)/100 recovers the compressed
    nnz-bytes. This reading is self-consistent for hypersparse graph
    adjacencies (s_A → 100%), where interpreting α as the compressed size
    would make M_C vanish. The resulting estimate,
    M_C ≈ 3·nnz_A·itemsize·(1 + α_B/α_A + dens_B), matches the expected
    output fill E[matches per A-nonzero] ≈ F·dens_B for uniform B.

    With sparsity_pct=0 (dense device-resident features) the
    output C = X is dense (N, F), so M_C is additionally capped at the dense
    footprint — Eq. 5 is an upper bound for compressed C.

    Both historical entry points (`plan_memory_spec` for compressed feature
    matrices, `plan_memory_dense_features` for the dense GCN aggregation)
    are thin wrappers over this function, so they agree by construction —
    in particular they produce the same M_C for dense features, which lets
    the simulate↔execute cross-check hand both planners the same budget.
    """
    feat = FeatureSpec.of(feat)
    itemsize = float(a.data.dtype.itemsize)
    n_total = float(a.shape[0]) * float(a.shape[1])
    alpha_a_dense = n_total * itemsize
    alpha_b_dense = float(feat.dense_bytes)
    sparsity_a_pct = 100.0 * (1.0 - a.nnz / max(n_total, 1.0))
    m_c = estimate_output_bytes(alpha_a_dense, alpha_b_dense,
                                sparsity_a_pct, feat.sparsity_pct)
    if feat.sparsity_pct <= 0.0:
        m_c = min(m_c, float(a.shape[0]) * feat.n_cols * feat.dtype_bytes)
    m_b = float(feat.compressed_bytes)
    p = segment_budget(m_total, m_c, m_b)
    return MemoryEstimate(m_b=m_b, m_c=m_c, p=p, m_total=m_total,
                          feasible=p > 0.0)


def plan_memory_spec(
    a: CSR,
    feat: "FeatureSpec",
    m_total: float,
    index_bytes: int = 4,
) -> MemoryEstimate:
    """Eq. 5-7 with compressed (or dense) feature accounting.

    Thin wrapper over `plan_memory_unified` (the paper-faithful reading),
    kept for its established name.
    """
    return plan_memory_unified(a, feat, m_total, index_bytes=index_bytes)


def required_bytes(a: CSR, feat: "FeatureSpec") -> float:
    """Table II 'Memory Req.': combined size of A, B and C."""
    est = plan_memory_unified(a, feat, m_total=float("inf"))
    return float(a.nbytes()) + est.m_b + est.m_c


def plan_memory_dense_features(
    a: CSR,
    n_nodes: int,
    feature_dim: int,
    m_total: float,
    feature_bytes: int = 4,
    index_bytes: int = 4,
) -> MemoryEstimate:
    """Memory plan for GCN aggregation X = Ã·H with *dense* device features.

    The feature matrix H is dense and device-resident:
    M_B = N·F·bytes, and M_C is Eq. 5 capped at the dense X footprint. Thin
    wrapper over `plan_memory_unified` with a sparsity_pct=0 FeatureSpec —
    identical, by construction, to `plan_memory_spec` on the same dense
    spec (the two used to read Eq. 5 differently; see ROADMAP history).
    """
    return plan_memory_unified(
        a, FeatureSpec(n_nodes, feature_dim, feature_bytes, 0.0,
                       index_bytes=index_bytes),
        m_total, index_bytes=index_bytes)


def calc_mem(k_rows: int, q_nnz: int, value_bytes: int = 4,
             index_bytes: int = 4) -> int:
    """`calcMem(k, q)` from Algorithm 1: bytes for a k-row, q-nnz CSR block.

    (k+1) row pointers + q column ids + q values.
    """
    return (k_rows + 1) * index_bytes + q_nnz * (index_bytes + value_bytes)


def ell_bucket_capacity(true_width: int, buckets: Optional[list] = None) -> int:
    """Pick the BlockELL bucket ≥ true tile width (powers of two).

    Capacity planning in place of dynamic allocation: segments are padded
    to the chosen bucket, so brick shapes vary only across buckets.

    With an explicit bucket list, a `true_width` larger than every bucket is
    an error: silently returning `max(buckets)` would pad the segment to a
    capacity *smaller* than its true tile width, truncating nonzeros.
    """
    if true_width <= 0:
        return 1
    if buckets:
        for b in sorted(buckets):
            if b >= true_width:
                return b
        raise ValueError(
            f"ell_bucket_capacity: true_width {true_width} exceeds every "
            f"explicit bucket {sorted(buckets)} — a segment padded to "
            f"{max(buckets)} would silently truncate; add a larger bucket "
            "or omit `buckets` for the power-of-two path")
    return 1 << max(0, math.ceil(math.log2(true_width)))
