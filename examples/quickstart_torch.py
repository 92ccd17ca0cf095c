"""Quickstart of the PyTorch port: the paper's technique in a few lines.

Out-of-core SpGEMM of a graph adjacency against dense features through the
AIRES pipeline (Eq. 5-7 planning -> RoBW partitioning -> double-buffered
streaming -> the Block-ELL SpMM kernel on the card), verified against the
oracle, as `examples/quickstart.py` does with the JAX package.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    AiresConfig, AiresSpGEMM, plan_memory_dense_features, resolve_device,
)
from repro_torch.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro_torch.sparse import spgemm_csr_dense


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # A socLJ1-like power-law graph, scaled down.
    a = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["socLJ1"], 1e-4), seed=0))
    h = np.random.default_rng(0).standard_normal(
        (a.n_rows, 32)).astype(np.float32)

    # Budget: the Eq. 5-7 resident set (M_B + M_C) must fit; granting only
    # a fraction of A's bytes on top forces out-of-core streaming.
    est = plan_memory_dense_features(a, a.n_rows, h.shape[1], float("inf"))
    budget = int(est.m_b + est.m_c + 0.5 * a.nbytes())
    engine = AiresSpGEMM(AiresConfig(device_budget_bytes=budget, bm=8, bk=8,
                                     device=args.device))
    x = engine(a, torch.from_numpy(h).to(dev))

    err = np.abs(x.cpu().numpy() - spgemm_csr_dense(a, h)).max()
    print(f"graph: {a.n_rows} nodes, {a.nnz} edges; "
          f"streamed {engine.last_stream_stats.segments} RoBW segments "
          f"on {dev}; max err vs oracle = {err:.2e}")
    if not err < 1e-4:
        raise AssertionError(f"max err vs oracle {err} >= 1e-4")
    print("OK")


if __name__ == "__main__":
    main()
