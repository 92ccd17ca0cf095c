"""Time the Block-ELL SpMM on row blocks far longer than the rest of their
segment, through the port's wrapper, in this checkout or another.

    PYTHONPATH=src python scripts/spmm_hub.py [--root DIR] [--repeats 50]

The cases come from chip_smoke.py's training plan (rUSA 1e-2, width 256):
its transposed segment 0, whose hub row block has 422 slots against a mean
of 20. The hub row block alone and the segment's 8 longest row blocks, at
F = 256 and 1024, and the whole segment at F = 256. Each case is checked
against the plain version within chip_smoke.py's REL_TOL of its scale,
then timed as `bcsr_spmm_cuda` calls: `ms` by CUDA events around
back-to-back calls (host work included), `device_ms` as the kernels' own
time in a torch.profiler trace. `--root` takes chip_smoke.py and
src/repro_torch from another checkout (an unpacked earlier commit, say),
so that one call can time two versions of the kernel on the same card.
Prints one JSON line per case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import types
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--repeats", type=int, default=50)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("spmm_hub.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    kmod = importlib.import_module("repro_torch.kernels.bcsr_spmm")
    kmod.build()

    a = cs.paper_graph("rUSA", 1e-2, 1)
    eng = cs.engine_at(a, 256)
    ell = cs.first_segment(eng.stream_plan(a, (a.n_rows, 256), transpose=True),
                           eng.transpose_of(a))["ell"]
    longest = np.argsort(-ell.n_tiles, kind="stable")

    def rows(idx):
        idx = np.sort(idx)
        return types.SimpleNamespace(
            bm=ell.bm, bk=ell.bk, blocks=ell.blocks[idx],
            col_tile=ell.col_tile[idx], n_tiles=ell.n_tiles[idx])

    cases = [("hub row block alone", rows(longest[:1]), 256),
             ("hub row block alone", rows(longest[:1]), 1024),
             ("8 longest row blocks", rows(longest[:8]), 256),
             ("8 longest row blocks", rows(longest[:8]), 1024),
             ("transposed segment 0", ell, 256)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, sub, f in cases:
        bricks = cs.brick_tensors(sub)
        h = torch.randn((a.n_rows, f), device="cuda", generator=gen)

        def call():
            return kmod.bcsr_spmm_cuda(*bricks, h, bm=sub.bm, bk=sub.bk)

        plain = kmod.bcsr_spmm_plain(*bricks, h, bm=sub.bm, bk=sub.bk)
        err = float((call() - plain).abs().max())
        scale = float(plain.abs().max())
        if not err <= cs.REL_TOL * scale:
            raise AssertionError(f"{label}, F={f}: |kernel - plain| {err}")
        print(json.dumps({
            "root": str(root), "case": label, "blocks": list(sub.blocks.shape),
            "n_tiles": [int(sub.n_tiles.min()), int(sub.n_tiles.max())],
            "f": f, "max_abs_err": err, "max_abs_plain": scale,
            "ms": cs.cuda_ms(call, args.repeats),
            "device_ms": cs.device_ms(call, args.repeats)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
