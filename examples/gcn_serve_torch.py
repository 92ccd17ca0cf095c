"""Serving-engine demo of the PyTorch port: the quickstart graph, twice,
through the cache.

Epoch 1 streams every BlockELL segment host→device; epoch 2 finds them in
the tiered segment cache and uploads (almost) nothing. A second graph
shares the same engine and cache budget to show multi-graph serving. The
same checks as `examples/gcn_serve.py`, on the card unless `--device cpu`.

Run:  PYTHONPATH=src python examples/gcn_serve_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import plan_memory_dense_features
from repro_torch.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro_torch.runtime import EngineConfig, InferenceRequest, ServingEngine
from repro_torch.sparse import spgemm_csr_dense


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    # The quickstart graph plus a road-network graph, multi-graph style.
    lj = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    road = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["rUSA"], 2e-5), seed=1))

    rng = np.random.default_rng(0)
    # Feasible for the engine's pinned plan width (64) on both graphs, with
    # enough slack that each graph still streams in several segments.
    budget = max(
        int(est.m_b + est.m_c + 0.6 * a.nbytes())
        for a in (lj, road)
        for est in [plan_memory_dense_features(a, a.n_rows, 64,
                                               float("inf"))])
    engine = ServingEngine(EngineConfig(device_budget_bytes=budget,
                                        device=args.device))
    engine.register_graph("socLJ1", lj)
    engine.register_graph("rUSA", road)

    h = rng.standard_normal((lj.n_rows, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    h_road = rng.standard_normal((road.n_rows, 16)).astype(np.float32)

    reports = []
    for epoch in range(2):
        engine.submit(InferenceRequest("socLJ1", h, [w]))
        engine.submit(InferenceRequest("rUSA", h_road))
        rep = engine.run_batch()
        reports.append(rep)
        print(f"epoch {epoch}: uploaded {rep.uploaded_bytes} B, "
              f"cache-hit {rep.cache_hit_bytes} B "
              f"(promoted {rep.promoted_bytes} B, hit rate "
              f"{rep.hit_rate:.0%}) in {rep.wall_seconds:.3f}s on "
              f"{engine.device}")

    out = next(r.output for r in reports[0].results if r.graph == "socLJ1")
    err = np.abs(out - spgemm_csr_dense(lj, h) @ w).max()
    print(f"max err vs oracle = {err:.2e}")
    if not err < 1e-3:
        raise AssertionError(f"max err vs oracle {err} >= 1e-3")
    if not reports[1].uploaded_bytes <= reports[0].uploaded_bytes // 2:
        raise AssertionError("second epoch should reuse cached segments")
    print("OK")


if __name__ == "__main__":
    main()
