"""End-to-end example of the PyTorch port: train a GCN, checking the
out-of-core AIRES aggregation against the in-core one as it goes.

A small GCN (64-dim features, two hidden layers of 64, 8 classes) trains
with AdamW on a synthetic kmer-style graph, through the dense in-core
aggregation; every `--out-of-core-every` steps the aggregation X = Ã H
runs through the AIRES stream (the Block-ELL SpMM kernel on the card) and
must agree with the in-core one, forward and backward (the backward
streams Aᵀ for real).

Run:
    PYTHONPATH=src python examples/gcn_train_e2e_torch.py [--steps 200] \
        [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import AiresConfig, AiresSpGEMM, resolve_device
from repro_torch.data import (
    SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
)
from repro_torch.models import GCNConfig, gcn_init, gcn_loss
from repro_torch.sparse import csr_to_dense
from repro_torch.train import make_optimizer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out-of-core-every", type=int, default=50,
                    help="check the streamed path every N steps")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # Graph, features and labels, as the JAX package's example draws them.
    a = normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS["kV2a"], 5e-6), seed=0))
    n = a.n_rows
    rng = np.random.default_rng(0)
    cfg = GCNConfig(feature_dim=64, hidden_dims=(64, 64), n_classes=8,
                    out_of_core=True,
                    device_budget_bytes=int((a.nbytes() + n * 64 * 4 * 3)
                                            * 0.6))
    h0 = torch.from_numpy(rng.standard_normal(
        (n, cfg.feature_dim)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes,
                                           size=(n,))).to(dev)
    params = gcn_init(cfg, torch.Generator().manual_seed(0), device=dev)
    init_opt, opt_update = make_optimizer("adamw", lr=2e-3)
    opt = init_opt(params)

    a_dense = torch.from_numpy(csr_to_dense(a)).to(dev)   # in-core path
    engine = AiresSpGEMM(AiresConfig(
        device_budget_bytes=cfg.device_budget_bytes, bm=8, bk=8,
        device=str(dev)))

    def step(params, opt):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = gcn_loss(cfg, leaves, a_dense, h0, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params, opt = opt_update(params, dict(zip(leaves, grads)), opt)
        return loss.detach(), params, opt

    t0 = time.perf_counter()
    for s in range(args.steps):
        loss, params, opt = step(params, opt)
        if s % 25 == 0:
            print(f"step {s:>4d} loss {float(loss):.4f}")
        if s % args.out_of_core_every == 0:
            # The streamed aggregation must agree with the in-core one,
            # forward and backward.
            x_stream = engine(a, h0)
            assert float((x_stream - a_dense @ h0).abs().max()) < 1e-3
            h = h0.clone().requires_grad_(True)
            (g_stream,) = torch.autograd.grad(
                (engine(a, h) ** 2).sum(), h)
            h_ref = h0.clone().requires_grad_(True)
            (g_ref,) = torch.autograd.grad(
                ((a_dense @ h_ref) ** 2).sum(), h_ref)
            assert float((g_stream - g_ref).abs().max()) < 1e-2
            assert engine.last_backward_stream_stats.segments >= 1
    print(f"final loss {float(loss):.4f} in {time.perf_counter() - t0:.1f}s "
          f"({args.steps} steps on {dev}, out-of-core checks passed)")


if __name__ == "__main__":
    main()
