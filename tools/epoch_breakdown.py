"""Split the wall time of chip_smoke.py's `epoch` phase into its parts.

    PYTHONPATH=src python tools/epoch_breakdown.py [--epochs 2]

Runs `gcn_epoch(mode="execute")` under AIRES on rUSA 1e-2 with
gcn_paper's widths at the `epoch` phase's budget, as chip_smoke.py does,
with timers around the engine's host preparation (`AiresSpGEMM._prepare`:
RoBW, transpose, densification, pinning; the cached calls take
nanoseconds) and around each streamed pass (`_stream_spmm`: uploads on
the copy stream and the SpMM launches, up to the streamer's final
synchronize), split by direction. What is left of `wall_seconds` is
autograd, the dense products and relus, and the allocations between.
Each epoch builds a fresh engine, so every run pays the preparation.
Prints one JSON line per epoch, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("epoch_breakdown.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.core import AiresConfig, AiresSpGEMM, gcn_epoch
    from repro_torch.io import PAPER_GPU_SYSTEM

    torch.backends.cuda.matmul.allow_tf32 = False
    a = cs.paper_graph("rUSA", 1e-2, 1)
    dims = CONFIG.layer_dims()
    gen = torch.Generator().manual_seed(args.seed + 4)
    h0 = torch.randn((a.n_rows, dims[0][0]), generator=gen).cuda()
    ws = [(torch.randn((fi, fo), generator=gen) * fi ** -0.5).cuda()
          for fi, fo in dims]
    budget = cs.serve_budget(a, CONFIG.feature_dim)

    spent = {}

    def timed(name, fn):
        def wrapper(self, *a_, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a_, **kw)
            torch.cuda.synchronize()
            key = name(a_, kw)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def direction(transpose):
        return "backward" if transpose else "forward"

    AiresSpGEMM._prepare = timed(
        lambda a_, kw: "prepare_" + direction(
            kw.get("transpose", a_[2] if len(a_) > 2 else False)),
        AiresSpGEMM._prepare)
    AiresSpGEMM._stream_spmm = timed(
        lambda a_, kw: "stream_" + direction(a_[0].a is not a),
        AiresSpGEMM._stream_spmm)
    for epoch in range(args.epochs):
        spent.clear()
        em = gcn_epoch(a, h0, ws, "aires", PAPER_GPU_SYSTEM, budget,
                       mode="execute", engine_config=AiresConfig(
                           budget, bm=8, bk=8))
        rest = em.wall_seconds - sum(spent.values())
        print(json.dumps({
            "epoch": epoch, "wall_seconds": em.wall_seconds,
            **{k: spent[k] for k in sorted(spent)},
            "autograd_dense_and_other_s": rest,
            "uploaded_bytes": sum(s.uploaded_bytes for s in
                                  em.forward_stream + em.backward_stream),
            "segments": sum(s.segments for s in
                            em.forward_stream + em.backward_stream)}),
            flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
