#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--rusa-scale 1e-2] [--lj-scale 1e-3] [--seed 0]

Phases, one JSON line each; any failure raises and the script exits
non-zero without a result line:

  1. env     — versions and the card; TF32 is switched off for matmuls.
  2. build   — nvcc builds the Block-ELL SpMM kernel from this checkout.
  3. kernel  — the kernel against its plain PyTorch version on the card:
               at the main path's shape (the rUSA graph's first streamed
               segment against its resident H) and on a ragged shape, f16
               operands and an empty row block.
  4. serve   — the port's `ServingEngine` on the card, two gcn_paper-width
               graphs, two epochs of four requests each, every output held
               against a float64 scipy reference of the request semantics;
               the kernel's launch count must equal the segments streamed.
  5. timing  — kernel, plain version and `torch.sparse.mm` (a yardstick the
               port never calls) at the main path's shape, and the bound.
  6. kernels — the summary line, then the card's name and power limit, then
               the result line.

It needs no network and one card, and exits non-zero when no card is
visible or when the package is not beside it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
MAIN_TOL = 1e-4                # f32, sums in another order
F16_TOL = 1e-2
SERVE_TOL = 1e-3               # f32 engine vs float64 after three layers


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def paper_graph(name: str, scale: float, seed: int):
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    return normalized_adjacency(generate_graph(
        scaled_spec(SUITESPARSE_SPECS[name], scale), seed=seed))


def serve_budget(a, width: int) -> int:
    """launch/serve.py's budget rule at the engine's plan width."""
    from repro_torch.core import plan_memory_dense_features
    est = plan_memory_dense_features(a, a.n_rows, width, float("inf"))
    return int(est.m_b + est.m_c + 0.6 * a.nbytes())


def phase_kernel(kmod, main_ell, h_main):
    """Kernel vs plain version on the card; returns the main-shape error."""
    import numpy as np
    import torch
    from repro_torch.sparse import csr_from_dense, tile_csr_to_block_ell

    def compare(ell, h, tol, label):
        args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in (ell.blocks, ell.col_tile, ell.n_tiles)]
        out = kmod.bcsr_spmm_cuda(*args, h, bm=ell.bm, bk=ell.bk)
        plain = kmod.bcsr_spmm_plain(*args, h, bm=ell.bm, bk=ell.bk)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        if not err <= tol:
            raise AssertionError(f"{label}: max |kernel - plain| {err} > {tol}")
        return {"case": label, "blocks": list(ell.blocks.shape),
                "blocks_dtype": str(ell.blocks.dtype),
                "h": list(h.shape), "h_dtype": str(h.dtype).split(".")[-1],
                "max_abs_err": err, "tol": tol}

    rng = np.random.default_rng(1)
    cases = [compare(main_ell, h_main, MAIN_TOL, "main-path rUSA segment 0")]
    dense = ((rng.random((1003, 997)) < 0.01)
             * rng.standard_normal((1003, 997))).astype(np.float32)
    ragged = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(ragged, torch.randn(997, 200, device="cuda"),
                         MAIN_TOL, "ragged 1003x997, F=200"))
    f16 = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8,
                                dtype=np.float16)
    cases.append(compare(f16, torch.randn(997, 256, device="cuda").half(),
                         F16_TOL, "f16 blocks and H"))
    dense = np.zeros((40, 40), np.float32)
    dense[3, 5], dense[33, 39] = 2.0, -1.0      # row blocks 1-3 empty
    empty = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(empty, torch.randn(40, 64, device="cuda"),
                         MAIN_TOL, "empty row blocks"))
    emit({"phase": "kernel", "cases": cases})
    return cases[0]["max_abs_err"]


def reference_outputs(a, features, weights):
    """float64 scipy reference: h <- relu((A h) W_l), last layer linear."""
    import numpy as np
    import scipy.sparse as sp
    a64 = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                        shape=a.shape)
    hs = [f.astype(np.float64) for f in features]
    for layer, w in enumerate(weights):
        x = a64 @ np.concatenate(hs, axis=1)
        f = hs[0].shape[1]
        hs = [x[:, i * f:(i + 1) * f] @ w.astype(np.float64)
              for i in range(len(hs))]
        if layer < len(weights) - 1:
            hs = [np.maximum(h, 0.0) for h in hs]
    return hs


def phase_serve(kmod, graphs, args):
    import numpy as np
    import torch
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.models import gcn_init
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    gen = torch.Generator().manual_seed(args.seed)
    params = gcn_init(CONFIG, gen, device="cpu")
    weights = [params[f"w{i}"].numpy() for i in range(3)]
    width = 4 * CONFIG.feature_dim
    engines, requests, refs = {}, {}, {}
    t0 = time.perf_counter()
    for name, a in graphs.items():
        eng = ServingEngine(EngineConfig(
            device_budget_bytes=serve_budget(a, width),
            max_batch_features=width))
        eng.register_graph(name, a)
        engines[name] = eng
        requests[name] = [torch.randn((a.n_rows, CONFIG.feature_dim),
                                      generator=gen).numpy()
                          for _ in range(4)]
        refs[name] = reference_outputs(a, requests[name], weights)
    setup_s = time.perf_counter() - t0

    kmod.LAUNCHES = 0                      # the main path starts here
    epochs = []
    for epoch in range(args.epochs):
        row = {"epoch": epoch, "graphs": {}}
        for name, eng in engines.items():
            for h in requests[name]:
                eng.submit(InferenceRequest(name, h, weights))
            rep = eng.run_batch()
            row["graphs"][name] = {
                "wall_s": rep.wall_seconds,
                "uploaded_bytes": rep.uploaded_bytes,
                "cache_hit_bytes": rep.cache_hit_bytes,
                "promoted_bytes": rep.promoted_bytes,
                "segments_streamed": rep.segments_streamed,
                "aggregation_passes": rep.aggregation_passes,
                "max_abs_err_vs_float64": 0.0,
            }
            for res, ref in zip(rep.results, refs[name]):
                out = res.output
                if out.shape != ref.shape or not np.isfinite(out).all():
                    raise AssertionError(f"{name}: bad output {out.shape}")
                err = float(np.abs(out - ref).max())
                row["graphs"][name]["max_abs_err_vs_float64"] = max(
                    row["graphs"][name]["max_abs_err_vs_float64"], err)
                if not err <= SERVE_TOL:
                    raise AssertionError(
                        f"{name} epoch {epoch}: |out - float64 ref| {err}")
        epochs.append(row)
    launches = kmod.LAUNCHES              # ... and ends here
    segments = sum(g["segments_streamed"] for row in epochs
                   for g in row["graphs"].values())
    if launches != segments or launches == 0:
        raise AssertionError(f"kernel launches {launches} != segments "
                             f"streamed {segments}")
    for name in graphs:
        first, last = (epochs[0]["graphs"][name]["uploaded_bytes"],
                       epochs[-1]["graphs"][name]["uploaded_bytes"])
        if not last < first:
            raise AssertionError(f"{name}: epoch {args.epochs - 1} uploaded "
                                 f"{last} B, not below epoch 0's {first} B")
    emit({"phase": "serve", "setup_s": setup_s,
          "graphs": {name: {"n": a.n_rows, "nnz": a.nnz,
                            "budget_bytes": engines[name].config
                            .device_budget_bytes,
                            "requests_per_epoch": 4,
                            "layers": [list(w.shape) for w in weights]}
                     for name, a in graphs.items()},
          "epochs": epochs, "kernel_launches": launches,
          "segments_streamed": segments})
    return launches


def phase_timing(kmod, main_ell, main_csr, h_main):
    import numpy as np
    import torch

    args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
            for x in (main_ell.blocks, main_ell.col_tile, main_ell.n_tiles)]
    bm, bk = main_ell.bm, main_ell.bk
    k_rows, f = h_main.shape
    ms = cuda_ms(lambda: kmod.bcsr_spmm_cuda(*args, h_main, bm=bm, bk=bk), 20)
    plain_ms = cuda_ms(lambda: kmod.bcsr_spmm_plain(*args, h_main, bm=bm,
                                                    bk=bk), 3, warmup=1)
    a_csr = torch.sparse_csr_tensor(
        torch.from_numpy(main_csr.indptr.astype(np.int64)),
        torch.from_numpy(main_csr.indices.astype(np.int64)),
        torch.from_numpy(main_csr.data.copy()), size=main_csr.shape,
        check_invariants=True).cuda()
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, h_main), 20)

    # Least work for these inputs: the valid bricks read once, the H tiles
    # they reference read once, col_tile and n_tiles read once, X written
    # once; 2*bm*bk FLOPs per valid brick and feature column.
    n_tiles, col_tile = args[2].long(), args[1]
    slots = torch.arange(col_tile.shape[1], device="cuda")[None, :]
    valid = (slots < n_tiles[:, None]) & (col_tile >= 0)
    n_valid = int(valid.sum())
    h_tiles = int(torch.unique(col_tile[valid]).numel())
    item = main_ell.blocks.dtype.itemsize
    nbytes = (n_valid * bm * bk * item + col_tile.numel() * 4
              + n_tiles.numel() * 4
              + min(h_tiles * bk, k_rows) * f * h_main.element_size()
              + main_ell.n_row_blocks * bm * f * 4)
    flops = 2.0 * n_valid * bm * bk * f
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    emit({"phase": "timing", "shape": {"blocks": list(main_ell.blocks.shape),
                                       "h": [k_rows, f]},
          "valid_bricks": n_valid, "h_tiles_referenced": h_tiles,
          "min_bytes": nbytes, "flops": flops, "ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "library_call": "torch.sparse.mm (CUDA CSR)",
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_share": bound_ms / ms})
    return ms, plain_ms, library_ms, bound_ms, bound_by


def run(args) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "tf32": "off (matmul and cudnn)",
          "scales": {"rUSA": args.rusa_scale, "socLJ1": args.lj_scale}})

    from repro_torch.kernels import bcsr_spmm as kmod
    info = kmod.build()
    emit({"phase": "build", "seconds": info.seconds,
          "library": str(info.library.relative_to(ROOT)),
          "ptxas": [ln.strip() for ln in info.ptxas.splitlines()
                    if "registers" in ln or "smem" in ln or "spill" in ln]})

    from repro_torch.core import AiresConfig, AiresSpGEMM
    from repro_torch.sparse import csr_row_slice

    t0 = time.perf_counter()
    # Seeds follow launch/serve.py: graphs in ("socLJ1", "rUSA") order.
    graphs = {"rUSA": paper_graph("rUSA", args.rusa_scale, 1),
              "socLJ1": paper_graph("socLJ1", args.lj_scale, 0)}
    a = graphs["rUSA"]
    width = 1024
    plan = AiresSpGEMM(AiresConfig(
        device_budget_bytes=serve_budget(a, width), bm=8, bk=8,
        plan_features=width, device="cuda")).stream_plan(a, (a.n_rows, width))
    main_ell = plan.stream_payloads()[0][1]
    seg0 = plan.robw.segments[0]
    main_csr = csr_row_slice(a, seg0.row_start, seg0.row_end)
    emit({"phase": "host", "seconds": time.perf_counter() - t0,
          "rUSA_segments": [list(e.blocks.shape)
                            for _, e in plan.stream_payloads()]})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    h_main = torch.randn((a.n_rows, width), device="cuda", generator=gen)

    max_err = phase_kernel(kmod, main_ell, h_main)
    launches = phase_serve(kmod, graphs, args)
    ms, plain_ms, library_ms, bound_ms, bound_by = phase_timing(
        kmod, main_ell, main_csr, h_main)
    emit({"kernels": [{
        "name": "bcsr_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
        "replaces": "src/repro/kernels/bcsr_spmm.py:50",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rusa-scale", type=float, default=1e-2)
    ap.add_argument("--lj-scale", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.epochs < 2:
        ap.error("--epochs must be at least 2 (epoch 2 checks the cache)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
