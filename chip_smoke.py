#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--rusa-scale 1e-2] [--lj-scale 1e-3] [--seed 0]

Phases, one JSON line each; any failure raises and the script exits
non-zero without a result line:

  1. env     — versions and the card; TF32 is switched off for matmuls.
  2. build   — nvcc builds the kernel library from this checkout's sources.
  3. host    — the rUSA plans: serving at width 1024, training at 256 in
               both directions.
  4. kernel  — the SpMM kernel against its plain PyTorch version on the
               card: at the serving path's shape (the rUSA graph's first
               streamed segment against its resident H), with bf16 H over
               f32 and over bf16 bricks there, on the training plan's first
               transposed segment and on its 422-slot hub row block alone,
               on socLJ1's first serving segment, on a ragged shape, with a
               zeroed brick in every row block, with dense bricks, f16
               operands and empty row blocks; every case must take the
               "zero_skip" route.
  5. fused   — the fused GCN-layer kernel against its plain version: the
               training plan's first segment at gcn_paper width (F_out 256
               and 64), a ragged shape and empty row blocks, each on the
               "grouped" route.
  6. serve   — the port's `ServingEngine` on the card, two gcn_paper-width
               graphs, two epochs of four requests each, every output held
               against a float64 scipy reference of the request semantics;
               the kernel's launch count must equal the segments streamed.
  7. layer   — `AiresSpGEMM.gcn_layer` at gcn_paper width on rUSA, forward
               and backward of Σ tanh(y), against a float64 autograd
               reference; the fused kernel runs once per forward segment,
               the SpMM once per recompute and transposed segment.
  8. train   — `gcn_train_loop`, gcn_paper (256→256→256→64) on rUSA, three
               AdamW steps; the first step's loss and gradients against
               float64, the loss must fall, SpMM launches must equal the
               segments streamed forward and backward.
               serve, layer and train fail unless every SpMM launch took
               the "zero_skip" route and every fused one "grouped".
  9. attn    — the flash-attention and GQA flash-decode kernels against
               their plain versions: flash at Yi-6B's prefill shape (causal),
               with a window of 512, at a ragged S and in f32; decode at
               decode_32k's shape with per-sequence lengths (1 and S among
               them), in f32, with a group of 1 (MHA) and a ragged cache.
               The 16-bit (tensor-core) kernels also at the edges of their
               64-row tiles: flash at S = 63, 64, 65, 129, with a window
               whose edge crosses tiles, and in f16; decode with lens one
               below, at and one above tile and split edges, with groups of
               1, 5 and 16, and in f16.
 10. lm_check — Yi-6B width cut to 4 layers, float32, batch 2 x 128
               tokens: `forward` and a teacher-forced `decode_step` at every
               position against the script's own float64 forward; flash
               launches = 4, decode launches = 4 x 128.
 11. lm_serve — full Yi-6B (32 layers, bf16, weights from --seed):
               `serve` of 4 prompts of 128 tokens for 32 steps (decode
               launches = 32 x 160), `forward` on one 4096-token sequence
               (flash launches = 32), and teacher-forced decode logits
               against that forward's over the first 128 positions. Every
               attention launch of lm_serve takes the tensor-core route,
               every one of lm_check the f32 FMA route.
 12. timing  — each kernel, its plain version and a PyTorch yardstick the
               port never calls, at the main paths' shapes, with the bound;
               the GCN kernels' bound counted on the bricks' nonzeros and,
               beside it, on every brick entry, and the fused layer's also
               with X·W at the rate of its three TF32 products; the SpMM
               also on socLJ1's first serving segment; decode also at
               lm_serve's own shape.
 13. kernels — the summary line, then the card's name and power limit, then
               the result line.

Each main path (serve, layer, train, lm_check, lm_serve) runs with the
launch counters set to 0 just before it and read just after. It needs no
network and one card, and exits non-zero when no card is visible or when
the package is not beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12       # H100 SXM bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12       # H100 SXM TF32 tensor cores, dense
MAIN_TOL = 1e-4                # f32, sums in another order
F16_TOL = 1e-2
# bf16 bricks and H against the plain version at the serving shape: every
# bf16 value converts to f32 exactly and both sides sum f32 products, so
# they differ only in the order of the sums, as f32 operands do.
BF16_TOL = 1e-4
SERVE_TOL = 1e-3               # f32 engine vs float64 after three layers
# f32 training path vs float64, as max |Δ| over the reference's largest
# magnitude: dW and db sum up to 239,400 row terms, whose rounding error
# grows like sqrt(n)·2^-24 ≈ 3e-5 of that scale. The float64 reference
# takes its relu masks from the card's forward: an f32 pre-activation
# within rounding of 0 may fall on the other side of the kink, which
# changes that row's gradient by O(1) at any precision.
REL_TOL = 1e-4
TRAIN_STEPS = 3
TRAIN_LR = 1e-3
# Attention kernels against their plain versions, per element:
# |kernel - plain| <= rtol·|plain| + atol. Both sides compute in f32 and sum
# in other orders (a gap near 1e-6 at the shapes here: the H100 measured at
# most 1.07e-6 in f32), then round once to the output type. Two f32 values
# that close round to the same value or to neighbours, one ulp apart, and an
# ulp is at most 2^-7·|x| in bf16 and 2^-10·|x| in f16; atol takes the f32
# gap. A typical |out| is 0.01 to 0.1 at these lengths, so atol lies three
# orders below it.
ATTN_TOL = {"float32": (0.0, 4e-6), "float16": (2.0 ** -10, 4e-6),
            "bfloat16": (2.0 ** -7, 4e-6)}
# The 4-layer float32 Yi-6B-width model against float64, as max |Δ| over
# the largest |logit|: sums of up to 11,008 f32 terms per layer, and RoPE
# angles of up to 127 rad taken in f32 (an error near 1e-5 rad).
LM_REL_TOL = 1e-4
# Full-depth bf16 Yi-6B: teacher-forced decode against the prefill forward,
# as max |Δ| over the largest |logit|. The two paths round in other places
# (matmuls of 1 row against 4096 rows, the two attention kernels' sums), 32
# layers deep; the first run on the H100 measured 0.0211, with the argmax
# agreeing at 96% of positions. The limit leaves room for other seeds.
LM_BF16_TOL = 0.05
PROFILED_STEPS = 4
LM_PROMPT = 128
LM_STEPS = 32
LM_BATCH = 4
LM_PREFILL = 4096


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_table(report: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v report: its name
    (demangled where the CUDA toolkit's cu++filt is found) and what ptxas
    said of its registers, stack and spills."""
    import os
    import re
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    names, props = [], []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            names.append(m.group(1))
            props.append([])
        elif names and ("Used" in ln or "spill" in ln):
            props[-1].append(ln.split(":", 1)[-1].strip())
    cufilt = shutil.which("cu++filt") or os.path.join(CUDA_HOME or "", "bin",
                                                      "cu++filt")
    if names and os.path.exists(cufilt):
        out = subprocess.run([cufilt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [re.sub(r"\(bool\)([01])",
                            lambda m: ("false", "true")[int(m.group(1))],
                            n.replace("(anonymous namespace)::", "")
                            .replace("<unnamed>::", "")).split("(")[0]
                     for n in out.stdout.splitlines()]
    return [f"{n}: {'; '.join(p)}" for n, p in zip(names, props)]


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


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


def brick_tensors(ell):
    import numpy as np
    import torch
    return [torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
            for x in (ell.blocks, ell.col_tile, ell.n_tiles)]


def zero_gcn_counts(kmod) -> None:
    """The Block-ELL kernels' launch counts, in all and by route, to 0."""
    kmod.LAUNCHES = kmod.FUSED_LAUNCHES = 0
    for routes in (kmod.SPMM_ROUTE_LAUNCHES, kmod.FUSED_ROUTE_LAUNCHES):
        for route in routes:
            routes[route] = 0


# Launches by route of each GCN main path, as check_gcn_routes read them.
GCN_ROUTES = {}


def check_gcn_routes(label: str, kmod, spmm: int, fused: int = 0) -> dict:
    """Every SpMM and fused launch counted since zero_gcn_counts took the
    zero-skipping route; returns the launches by route and keeps them in
    GCN_ROUTES[label]."""
    routes = {"bcsr_spmm": dict(kmod.SPMM_ROUTE_LAUNCHES),
              "fused_gcn_layer": dict(kmod.FUSED_ROUTE_LAUNCHES)}
    if (routes["bcsr_spmm"]["zero_skip"], routes["fused_gcn_layer"][
            "grouped"]) != (spmm, fused) or (
            sum(routes["bcsr_spmm"].values()),
            sum(routes["fused_gcn_layer"].values())) != (spmm, fused):
        raise AssertionError(f"{label}: launches by route {routes}, want "
                             f"{spmm} SpMM on zero_skip and {fused} fused "
                             "on grouped")
    GCN_ROUTES[label] = routes
    return routes


def launch_route(routes: dict, fn):
    """Calls `fn` once; returns its output and the one route whose launch
    count (in `routes`, a kernel module's counters) it raised."""
    before = dict(routes)
    out = fn()
    taken = [r for r in routes if routes[r] != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"one launch raised the counts of {taken}")
    return out, taken[0]


def phase_kernel(kmod, main_ell, h_main, bwd_ell, g_bwd, lj_ell, h_lj):
    """Kernel vs plain version on the card; returns the largest error at
    the main paths' shapes. Every case has 8 x 8 bricks and must take the
    "zero_skip" route."""
    import types

    import numpy as np
    import torch
    from repro_torch.sparse import csr_from_dense, tile_csr_to_block_ell

    def compare(ell, h, tol, label, relative=False, blocks=None):
        args = brick_tensors(ell)
        if blocks is not None:
            args[0] = blocks
        out, route = launch_route(kmod.SPMM_ROUTE_LAUNCHES, lambda: (
            kmod.bcsr_spmm_cuda(*args, h, bm=ell.bm, bk=ell.bk)))
        plain = kmod.bcsr_spmm_plain(*args, h, bm=ell.bm, bk=ell.bk)
        sync()
        err = float((out - plain).abs().max())
        scale = float(plain.abs().max())
        limit = tol * scale if relative else tol
        if not err <= limit:
            raise AssertionError(f"{label}: max |kernel - plain| {err} > "
                                 f"{limit}")
        if route != "zero_skip":
            raise AssertionError(f"{label}: took route {route}")
        return {"case": label, "blocks": list(args[0].shape),
                "blocks_dtype": str(args[0].dtype).split(".")[-1],
                "h": list(h.shape), "h_dtype": str(h.dtype).split(".")[-1],
                "route": route, "max_abs_err": err, "max_abs_plain": scale,
                "tol": f"{tol} x max |plain|" if relative else tol}

    rng = np.random.default_rng(1)
    cases = [compare(main_ell, h_main, MAIN_TOL, "main-path rUSA segment 0"),
             # Aᵀ's hub row blocks sum up to 422 bricks (3,376 terms) per
             # output: f32 rounding, held to the output's scale.
             compare(bwd_ell, g_bwd, REL_TOL,
                     "training plan's transposed rUSA segment 0, F=256",
                     relative=True),
             # 107 of its 208 row blocks pass the first kernel's 64 slots
             # and sum up to 512 bricks per output: held to its scale.
             compare(lj_ell, h_lj, REL_TOL,
                     "serving's socLJ1 segment 0, F=1024", relative=True)]
    h_bf16 = h_main.bfloat16()
    cases.append(compare(main_ell, h_bf16, BF16_TOL,
                         "serving shape, f32 bricks, bf16 H"))
    cases.append(compare(main_ell, h_bf16, BF16_TOL,
                         "serving shape, bf16 bricks and H",
                         blocks=brick_tensors(main_ell)[0].bfloat16()))
    # The hub: Aᵀ's row block with the most slots, alone, at its ell_w, so
    # its tail runs through the second zero-skip kernel.
    hub = int(np.argmax(bwd_ell.n_tiles))
    hub_ell = types.SimpleNamespace(
        bm=bwd_ell.bm, bk=bwd_ell.bk,
        blocks=bwd_ell.blocks[hub:hub + 1], col_tile=bwd_ell.col_tile[
            hub:hub + 1], n_tiles=bwd_ell.n_tiles[hub:hub + 1])
    case = compare(hub_ell, g_bwd, REL_TOL,
                   "transposed segment's hub row block alone", relative=True)
    case["n_tiles"] = int(bwd_ell.n_tiles[hub])
    cases.append(case)
    dense = ((rng.random((1003, 997)) < 0.01)
             * rng.standard_normal((1003, 997))).astype(np.float32)
    ragged = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(ragged, torch.randn(997, 200, device=DEV),
                         MAIN_TOL, "ragged 1003x997, F=200"))
    # A valid brick of zeros: no column of it is gathered.
    zeroed = brick_tensors(ragged)[0]
    zeroed[:, 0] = 0.0
    cases.append(compare(ragged, torch.randn(997, 200, device=DEV),
                         MAIN_TOL, "first brick of every row block zeroed",
                         blocks=zeroed))
    full = tile_csr_to_block_ell(csr_from_dense(rng.standard_normal(
        (64, 64)).astype(np.float32)), bm=8, bk=8)
    cases.append(compare(full, torch.randn(64, 256, device=DEV), MAIN_TOL,
                         "dense bricks, all 8 columns nonzero"))
    f16 = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8,
                                dtype=np.float16)
    cases.append(compare(f16, torch.randn(997, 256, device=DEV).half(),
                         F16_TOL, "f16 blocks and H"))
    dense = np.zeros((40, 40), np.float32)
    dense[3, 5], dense[33, 39] = 2.0, -1.0      # row blocks 1-3 empty
    empty = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(empty, torch.randn(40, 64, device=DEV),
                         MAIN_TOL, "empty row blocks"))
    emit({"phase": "kernel", "cases": cases})
    return max(c["max_abs_err"] for c in cases[:3])


def phase_fused(kmod, main_ell, h_main):
    """Fused kernel vs plain version on the card; returns the largest
    error at the main path's shape."""
    import numpy as np
    import torch
    from repro_torch.sparse import csr_from_dense, tile_csr_to_block_ell

    gen = torch.Generator(device=DEV).manual_seed(2)

    def compare(ell, h, f_out, label):
        f = h.shape[1]
        w = torch.randn((f, f_out), device=DEV, generator=gen) * f ** -0.5
        b = 0.1 * torch.randn((f_out,), device=DEV, generator=gen)
        args = brick_tensors(ell)
        out, route = launch_route(kmod.FUSED_ROUTE_LAUNCHES, lambda: (
            kmod.fused_gcn_layer_cuda(*args, h, w, b, bm=ell.bm, bk=ell.bk)))
        plain = kmod.fused_gcn_layer_plain(*args, h, w, b, bm=ell.bm,
                                           bk=ell.bk)
        sync()
        err = float((out - plain).abs().max())
        if not err <= MAIN_TOL:
            raise AssertionError(f"{label}: max |kernel - plain| {err} > "
                                 f"{MAIN_TOL}")
        if route != "grouped":
            raise AssertionError(f"{label}: took route {route}")
        return {"case": label, "blocks": list(ell.blocks.shape),
                "h": list(h.shape), "w": [f, f_out], "route": route,
                "max_abs_err": err, "tol": MAIN_TOL}

    rng = np.random.default_rng(3)
    cases = [compare(main_ell, h_main, h_main.shape[1],
                     "main-path rUSA training segment 0"),
             compare(main_ell, h_main, 64, "F_out=64, last gcn_paper layer")]
    dense = ((rng.random((1003, 997)) < 0.01)
             * rng.standard_normal((1003, 997))).astype(np.float32)
    ragged = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(ragged, torch.randn(997, 200, device=DEV,
                                             generator=gen),
                         120, "ragged 1003x997, F=200"))
    dense = np.zeros((40, 40), np.float32)
    dense[3, 5], dense[33, 39] = 2.0, -1.0      # row blocks 1-3 empty
    empty = tile_csr_to_block_ell(csr_from_dense(dense), bm=8, bk=8)
    cases.append(compare(empty, torch.randn(40, 64, device=DEV,
                                            generator=gen),
                         48, "empty row blocks"))
    emit({"phase": "fused", "cases": cases})
    return max(c["max_abs_err"] for c in cases[:2])


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

    zero_gcn_counts(kmod)                  # the main path starts here
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
    routes = check_gcn_routes("serve", kmod, launches)
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
          "launches_by_route": routes["bcsr_spmm"],
          "segments_streamed": segments})
    return launches


def f64_adjacency(a):
    """Ã as a float64 sparse COO tensor on the CPU: the yardstick of the
    training checks, never called by the port."""
    import numpy as np
    import torch
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    idx = torch.from_numpy(np.stack([rows, a.indices.astype(np.int64)]))
    return torch.sparse_coo_tensor(
        idx, torch.from_numpy(a.data.astype(np.float64)), a.shape,
        check_invariants=True).coalesce()


def rel_err(out, ref) -> float:
    """max |out - ref| over the reference's largest magnitude."""
    import torch
    out = out.detach().cpu().to(torch.float64)
    ref = ref.detach().cpu().to(torch.float64)
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"bad output {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)}")
    return float((out - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def check_errors(label: str, errs: dict) -> None:
    bad = {k: e for k, e in errs.items() if not e <= REL_TOL}
    if bad:
        raise AssertionError(f"{label}: relative error above {REL_TOL}: "
                             f"{bad}")


def engine_at(a, width: int):
    """An `AiresSpGEMM` planned at width `width`, with launch/serve.py's
    budget rule at that width."""
    from repro_torch.core import AiresConfig, AiresSpGEMM
    return AiresSpGEMM(AiresConfig(
        device_budget_bytes=serve_budget(a, width), bm=8, bk=8,
        plan_features=width, device=DEV))


def phase_layer(kmod, eng, a, a64, seed: int):
    """gcn_layer forward and backward at gcn_paper width; returns the
    fused and SpMM launches of the run."""
    import torch
    from repro_torch.configs.gcn_paper import CONFIG

    width = CONFIG.feature_dim
    eng.reset_stats_logs()
    gen = torch.Generator().manual_seed(seed + 1)
    h = torch.randn((a.n_rows, width), generator=gen)
    w = torch.randn((width, width), generator=gen) * width ** -0.5
    b = 0.1 * torch.randn((width,), generator=gen)
    leaves = [t.to(DEV).requires_grad_(True) for t in (h, w, b)]
    sync()

    zero_gcn_counts(kmod)                         # the main path starts here
    t0 = time.perf_counter()
    y = eng.gcn_layer(a, *leaves)
    sync()
    t1 = time.perf_counter()
    torch.sum(torch.tanh(y)).backward()
    sync()
    t2 = time.perf_counter()
    fused, launches = kmod.FUSED_LAUNCHES, kmod.LAUNCHES   # ... and ends here

    fwd = [s.segments for s in eng.forward_stats_log]
    bwd = [s.segments for s in eng.backward_stats_log]   # recompute, Aᵀ
    if fused != sum(fwd) or fused == 0:
        raise AssertionError(f"fused launches {fused} != forward segments "
                             f"{fwd}")
    if len(bwd) != 2 or launches != sum(bwd):
        raise AssertionError(f"SpMM launches {launches} != recompute + "
                             f"transposed segments {bwd}")
    routes = check_gcn_routes("layer", kmod, launches, fused)
    ref = [t.detach().to(torch.float64).requires_grad_(True)
           for t in (h, w, b)]
    mask = (y.detach() > 0).cpu()                 # see REL_TOL
    y64 = (torch.sparse.mm(a64, ref[0]) @ ref[1] + ref[2]) * mask
    torch.sum(torch.tanh(y64)).backward()
    errs = {"y": rel_err(y, y64)}
    errs.update({f"d{n}": rel_err(t.grad, r.grad)
                 for n, t, r in zip("Wb", leaves[1:], ref[1:])})
    errs["dH"] = rel_err(leaves[0].grad, ref[0].grad)
    check_errors("layer", errs)
    emit({"phase": "layer", "n": a.n_rows, "width": width,
          "forward_segments": fwd, "backward_segments": bwd,
          "fused_launches": fused, "spmm_launches": launches,
          "launches_by_route": routes,
          "forward_s": t1 - t0, "backward_s": t2 - t1,
          "rel_err_vs_float64": errs, "tol": REL_TOL})
    return fused, launches


def relu_masks(eng, a, params, h0):
    """The relu masks of gcn_forward's hidden layers on the card, from the
    same operations in the same order."""
    import torch
    n_layers = len([k for k in params if k.startswith("w")])
    masks, h = [], h0
    with torch.no_grad():
        for i in range(n_layers - 1):
            z = eng(a, h) @ params[f"w{i}"] + params[f"b{i}"]
            masks.append((z > 0).cpu())
            h = torch.relu(z)
    return masks


def f64_gcn_grads(a64, params, h0, labels, masks):
    """Loss and parameter gradients of gcn_loss in float64 on the CPU, the
    hidden relus given by `masks` (see REL_TOL)."""
    import torch
    p64 = {k: v.detach().to(torch.float64).requires_grad_(True)
           for k, v in params.items()}
    n_layers = len([k for k in p64 if k.startswith("w")])
    h = h0.to(torch.float64)
    for i in range(n_layers):
        h = torch.sparse.mm(a64, h) @ p64[f"w{i}"] + p64[f"b{i}"]
        if i < n_layers - 1:
            h = h * masks[i]
    gold = torch.gather(h, 1, labels.long()[:, None])[:, 0]
    loss = torch.mean(torch.logsumexp(h, dim=-1) - gold)
    grads = torch.autograd.grad(loss, list(p64.values()))
    return loss.detach(), dict(zip(p64, grads))


def phase_train(kmod, eng, a, a64, seed: int):
    """gcn_train_loop with gcn_paper on `a`; returns the SpMM launches."""
    import torch
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.models import gcn_init, gcn_loss
    from repro_torch.train import gcn_train_loop

    width = CONFIG.feature_dim
    eng.reset_stats_logs()
    gen = torch.Generator().manual_seed(seed + 2)
    params = gcn_init(CONFIG, gen, device="cpu")
    h0 = torch.randn((a.n_rows, width), generator=gen)
    labels = torch.randint(0, CONFIG.n_classes, (a.n_rows,), generator=gen)
    h0_dev, labels_dev = h0.to(DEV), labels.to(DEV)
    fwd_segs = len(eng.stream_plan(a, h0.shape).robw.segments)
    bwd_segs = len(eng.stream_plan(a, h0.shape, transpose=True).robw.segments)
    if fwd_segs < 2 or bwd_segs < 2:
        raise AssertionError(f"the budget must stream both directions: "
                             f"{fwd_segs} forward, {bwd_segs} backward "
                             "segments")

    # The first step's gradient, timed by direction, against float64.
    leaves = {k: v.to(DEV).requires_grad_(True) for k, v in params.items()}
    sync()
    t0 = time.perf_counter()
    loss = gcn_loss(CONFIG, leaves, a, h0_dev, labels_dev, engine=eng)
    sync()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    sync()
    t2 = time.perf_counter()
    masks = relu_masks(eng, a, leaves, h0_dev)
    ref_loss, ref_grads = f64_gcn_grads(a64, params, h0, labels, masks)
    errs = {"loss": rel_err(loss, ref_loss)}
    errs.update({f"d{k}": rel_err(g, ref_grads[k])
                 for k, g in zip(leaves, grads)})
    check_errors("train", errs)

    zero_gcn_counts(kmod)                         # the main path starts here
    trained, info = gcn_train_loop(CONFIG, eng, a, h0_dev, labels_dev,
                                   {k: v.to(DEV) for k, v in params.items()},
                                   n_epochs=TRAIN_STEPS, lr=TRAIN_LR)
    launches = kmod.LAUNCHES                      # ... and ends here
    routes = check_gcn_routes("train", kmod, launches)

    # One more step's gradient, warm, timed by direction.
    leaves = {k: v.requires_grad_(True) for k, v in trained.items()}
    sync()
    t3 = time.perf_counter()
    loss = gcn_loss(CONFIG, leaves, a, h0_dev, labels_dev, engine=eng)
    sync()
    t4 = time.perf_counter()
    torch.autograd.grad(loss, list(leaves.values()))
    sync()
    t5 = time.perf_counter()
    segments = sum(s.segments for ep in info["epochs"]
                   for s in ep["forward_stream"] + ep["backward_stream"])
    if launches != segments or launches == 0:
        raise AssertionError(f"SpMM launches {launches} != segments "
                             f"streamed {segments}")
    losses = [loss for _, loss in info["history"]]
    if abs(losses[0] - float(ref_loss)) > REL_TOL * abs(float(ref_loss)):
        raise AssertionError(f"first loss {losses[0]} vs float64 "
                             f"{float(ref_loss)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    emit({"phase": "train", "config": CONFIG.name,
          "layers": CONFIG.layer_dims(), "n": a.n_rows,
          "budget_bytes": eng.config.device_budget_bytes,
          "steps": TRAIN_STEPS, "optimizer": "adamw", "lr": TRAIN_LR,
          "first_step": {"forward_s": t1 - t0, "backward_s": t2 - t1},
          "warm_step": {"forward_s": t4 - t3, "backward_s": t5 - t4},
          "seconds_per_step": info["seconds"] / TRAIN_STEPS,
          "losses": losses, "float64_loss": float(ref_loss),
          "rel_err_vs_float64": errs, "tol": REL_TOL,
          "epochs": [{"forward_segments": [s.segments for s in
                                           ep["forward_stream"]],
                      "backward_segments": [s.segments for s in
                                            ep["backward_stream"]],
                      "uploaded_bytes": sum(
                          s.uploaded_bytes for s in
                          ep["forward_stream"] + ep["backward_stream"])}
                     for ep in info["epochs"]],
          "spmm_launches": launches,
          "launches_by_route": routes["bcsr_spmm"],
          "segments_streamed": segments})
    return launches


def brick_work(args, ell, k_rows: int, f: int, h_itemsize: int) -> dict:
    """What the aggregation needs for these inputs, counted two ways. Both
    read the valid bricks, col_tile and n_tiles once. By bricks: the H tiles
    the valid bricks reference, read once, and 2*bm*bk FLOPs per valid brick
    and feature column. By nonzeros: the H rows under the bricks' nonzero
    columns, read once, and 2 FLOPs per nonzero and feature column. The
    output is the caller's to add."""
    import torch
    blocks, col_tile, n_tiles = args
    slots = torch.arange(col_tile.shape[1], device=col_tile.device)[None, :]
    valid = (slots < n_tiles.long()[:, None]) & (col_tile >= 0)
    n_valid = int(valid.sum())
    tiles = col_tile[valid].long()
    h_tiles = int(torch.unique(tiles).numel())
    nz = blocks[valid] != 0                              # (n_valid, bm, bk)
    nnz = int(nz.sum())
    rows = tiles[:, None] * ell.bk + torch.arange(ell.bk, device=tiles.device)
    h_rows = int(torch.unique(rows[nz.any(dim=1) & (rows < k_rows)]).numel())
    fixed = (n_valid * ell.bm * ell.bk * blocks.element_size()
             + col_tile.numel() * 4 + n_tiles.numel() * 4)
    return {"valid_bricks": n_valid, "h_tiles_referenced": h_tiles,
            "nonzeros": nnz, "h_rows_referenced": h_rows,
            "bytes_bricks": fixed + min(h_tiles * ell.bk, k_rows) * f
            * h_itemsize,
            "flops_bricks": 2.0 * n_valid * ell.bm * ell.bk * f,
            "bytes": fixed + h_rows * f * h_itemsize,
            "flops": 2.0 * nnz * f}


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bounds(work: dict, extra_bytes: float, extra_flops: float) -> dict:
    """The bound on the nonzeros (`bound_ms`, `bound_by`) and the one on
    every brick entry (`bound_ms_bricks`, `bound_by_bricks`), each with the
    work beyond the aggregation added."""
    ms, by = bound(work["bytes"] + extra_bytes, work["flops"] + extra_flops)
    ms_b, by_b = bound(work["bytes_bricks"] + extra_bytes,
                       work["flops_bricks"] + extra_flops)
    return {"min_bytes": work["bytes"] + extra_bytes,
            "flops": work["flops"] + extra_flops, "bound_ms": ms,
            "bound_by": by, "min_bytes_bricks": work["bytes_bricks"]
            + extra_bytes, "flops_bricks": work["flops_bricks"] + extra_flops,
            "bound_ms_bricks": ms_b, "bound_by_bricks": by_b}


def csr_on_card(a):
    import numpy as np
    import torch
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data.copy()), size=a.shape,
        check_invariants=True).to(DEV)


def time_spmm(kmod, ell, csr, h) -> dict:
    """The SpMM kernel on one segment, its plain version and
    `torch.sparse.mm` (a yardstick the port never calls), with both
    bounds; `bound_share` is against the one on the nonzeros."""
    import torch
    args = brick_tensors(ell)
    bm, bk = ell.bm, ell.bk
    k_rows, f = h.shape
    _, route = launch_route(kmod.SPMM_ROUTE_LAUNCHES, lambda: (
        kmod.bcsr_spmm_cuda(*args, h, bm=bm, bk=bk)))
    ms = cuda_ms(lambda: kmod.bcsr_spmm_cuda(*args, h, bm=bm, bk=bk), 20)
    plain_ms = cuda_ms(lambda: kmod.bcsr_spmm_plain(*args, h, bm=bm, bk=bk),
                       3, warmup=1)
    a_csr = csr_on_card(csr)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_csr, h), 20)
    work = brick_work(args, ell, k_rows, f, h.element_size())
    b = bounds(work, ell.n_row_blocks * bm * f * 4, 0.0)      # X written
    return {"shape": {"blocks": list(ell.blocks.shape), "h": [k_rows, f]},
            "route": route,
            **{k: work[k] for k in ("valid_bricks", "h_tiles_referenced",
                                    "nonzeros", "h_rows_referenced")},
            **b, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "torch.sparse.mm (CUDA CSR)",
            "bound_share": b["bound_ms"] / ms}


def time_fused(kmod, ell, csr, h, f_out: int) -> dict:
    """The fused kernel on one segment, its plain version and the two-call
    yardstick `torch.sparse.mm` then `addmm` + `relu` (no single PyTorch
    call computes the fused function), with both bounds, and a third at the
    rate of the method the kernel uses: X·W as three TF32 tensor-core
    products (`bound_ms_split_tf32`, against which `bound_share` is
    taken)."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(4)
    k_rows, f = h.shape
    w = torch.randn((f, f_out), device=DEV, generator=gen) * f ** -0.5
    b = 0.1 * torch.randn((f_out,), device=DEV, generator=gen)
    args = brick_tensors(ell)
    bm, bk = ell.bm, ell.bk
    _, route = launch_route(kmod.FUSED_ROUTE_LAUNCHES, lambda: (
        kmod.fused_gcn_layer_cuda(*args, h, w, b, bm=bm, bk=bk)))
    ms = cuda_ms(lambda: kmod.fused_gcn_layer_cuda(*args, h, w, b, bm=bm,
                                                   bk=bk), 20)
    plain_ms = cuda_ms(lambda: kmod.fused_gcn_layer_plain(
        *args, h, w, b, bm=bm, bk=bk), 3, warmup=1)
    a_csr = csr_on_card(csr)
    yardstick_ms = cuda_ms(lambda: torch.relu(torch.addmm(
        b, torch.sparse.mm(a_csr, h), w)), 20)
    work = brick_work(args, ell, k_rows, f, h.element_size())
    rows = ell.n_row_blocks * bm
    xw_flops = 2.0 * rows * f * f_out
    bnd = bounds(work, (f * f_out + f_out) * 4 + rows * f_out * 4,  # W, b; Y
                 xw_flops)
    # The aggregation's FLOPs at the f32 rate, then X·W's three products
    # at the TF32 tensor-core rate (an f32-accurate ceiling of 165 TFLOP/s).
    t_bytes = bnd["min_bytes"] / PEAK_BYTES_PER_S
    t_ops = work["flops"] / PEAK_F32_FLOPS + 3 * xw_flops / PEAK_TF32_FLOPS
    split_ms = 1e3 * max(t_bytes, t_ops)
    return {"shape": {"blocks": list(ell.blocks.shape), "h": [k_rows, f],
                      "w": [f, f_out]},
            "route": route,
            **{k: work[k] for k in ("valid_bricks", "h_tiles_referenced",
                                    "nonzeros", "h_rows_referenced")},
            **bnd, "bound_ms_split_tf32": split_ms,
            "bound_by_split_tf32": "bytes" if t_bytes >= t_ops
            else "operations",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "yardstick_ms": yardstick_ms,
            "yardstick_call": "torch.sparse.mm (CUDA CSR), then addmm + relu",
            "bound_share": split_ms / ms}


def attn_compare(fn_cuda, fn_plain, args, kwargs, label, dtype,
                 lens_sweep: int = 0) -> dict:
    """One attention kernel against its plain version on the same inputs,
    per element within ATTN_TOL. With `lens_sweep` = S the decode kernel is
    called as `decode_step` calls it, once for each lens = t + 1 the same
    for every sequence, t in [0, S)."""
    import torch
    rtol, atol = ATTN_TOL[dtype]
    if lens_sweep:
        q, k, v, lens = args
        calls = [(q, k, v, torch.full_like(lens, t + 1))
                 for t in range(lens_sweep)]
    else:
        calls = [args]
    err = ratio = max_plain = sum_plain = 0.0
    n_plain = 0
    for call in calls:
        out = fn_cuda(*call, **kwargs)
        plain = fn_plain(*call, **kwargs)
        sync()
        if out.dtype != plain.dtype or out.shape != plain.shape:
            raise AssertionError(f"{label}: kernel gave {out.dtype} "
                                 f"{tuple(out.shape)}, plain {plain.dtype} "
                                 f"{tuple(plain.shape)}")
        delta = (out.float() - plain.float()).abs()
        mag = plain.float().abs()
        err = max(err, float(delta.max()))
        ratio = max(ratio, float((delta / (rtol * mag + atol)).max()))
        max_plain = max(max_plain, float(mag.max()))
        sum_plain += float(mag.sum())
        n_plain += mag.numel()
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: |kernel - plain| exceeds {rtol}·"
                             f"|plain| + {atol} by a factor {ratio} (max "
                             f"|Δ| {err})")
    case = {"case": label, "shape": [list(a.shape) for a in args[:3]],
            "dtype": dtype, **kwargs, "max_abs_err": err,
            "max_err_over_limit": ratio, "max_abs_plain": max_plain,
            "mean_abs_plain": sum_plain / n_plain, "rtol": rtol,
            "atol": atol}
    if lens_sweep:
        case["lens"] = f"every sequence t + 1, t in [0, {lens_sweep})"
    return case


def attn_inputs(shape, dtype, gen):
    import torch
    return [torch.randn(shape, device=DEV, generator=gen).to(
        getattr(torch, dtype)) for _ in range(3)]


def decode_inputs(b, n_kv, group, s_len, dtype, gen, lens=None):
    """q (b, n_kv, group, d=128), k, v (b, n_kv, s_len, 128) and lens drawn
    in [1, s_len] per sequence, the first s_len and the second 1."""
    import torch
    dt = getattr(torch, dtype)
    q = torch.randn((b, n_kv, group, 128), device=DEV, generator=gen).to(dt)
    k, v = (torch.randn((b, n_kv, s_len, 128), device=DEV,
                        generator=gen).to(dt) for _ in range(2))
    if lens is None:
        lens = torch.randint(1, s_len + 1, (b,), device=DEV, generator=gen,
                             dtype=torch.int32)
        lens[0] = s_len
        if b > 1:
            lens[1] = 1
    return q, k, v, lens


def phase_attn(fmod, dmod, seed: int) -> dict:
    """Both attention kernels against their plain versions on the card;
    returns each kernel's largest error at the shapes lm_check and lm_serve
    give it."""
    import torch
    from repro_torch.configs import SHAPES

    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    torch.cuda.reset_peak_memory_stats()
    flash, decode = fmod.flash_attention_cuda, dmod.decode_attention_cuda
    f_plain, d_plain = fmod.flash_attention_plain, dmod.decode_attention_plain
    cases = [attn_compare(flash, f_plain,
                          attn_inputs((1, 32, LM_PREFILL, 128), "bfloat16",
                                      gen), {"causal": True},
                          "flash: lm_serve's prefill layer (train_4k length)",
                          "bfloat16")]
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, LM_PREFILL, 128),
                                          "bfloat16", gen),
                              {"causal": True, "window": 512},
                              "flash: sliding window 512", "bfloat16"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((2, 8, 1000, 128), "bfloat16",
                                          gen), {"causal": True},
                              "flash: ragged S = 1000", "bfloat16"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, 1024, 128), "float32", gen),
                              {"causal": True}, "flash: f32", "float32"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((2, 32, LM_PROMPT, 128), "float32",
                                          gen), {"causal": True},
                              "flash: lm_check's forward, f32", "float32"))
    dec = SHAPES["decode_32k"]
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(dec["global_batch"], 4, 8,
                                       dec["seq_len"], "bfloat16", gen), {},
        "decode: decode_32k layer, per-sequence lens", "bfloat16"))
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(8, 4, 8, 4096, "float32", gen),
                              {}, "decode: f32", "float32"))
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(4, 32, 1, 2048, "bfloat16", gen),
                              {}, "decode: group 1 (MHA, as DeepSeek-7B)",
                              "bfloat16"))
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(4, 4, 8, 1000, "bfloat16", gen),
                              {}, "decode: ragged cache S = 1000",
                              "bfloat16"))
    serve_len = LM_PROMPT + LM_STEPS + 1        # serve's max_len
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(LM_BATCH, 4, 8, serve_len, "bfloat16",
                                       gen), {},
        "decode: lm_serve's cache, every position", "bfloat16",
        lens_sweep=serve_len))
    cases.append(attn_compare(
        decode, d_plain, decode_inputs(2, 4, 8, LM_PROMPT, "float32", gen),
        {}, "decode: lm_check's cache, every position", "float32",
        lens_sweep=LM_PROMPT))
    cases += tile_edge_cases(fmod, dmod, gen)
    emit({"phase": "attn", "cases": cases,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    torch.cuda.empty_cache()
    main = [c for c in cases if "lm_" in c["case"]]    # main-path shapes
    return {name: max(c["max_abs_err"] for c in main
                      if c["case"].startswith(name))
            for name in ("flash", "decode")}


def tile_edge_cases(fmod, dmod, gen) -> list:
    """The 16-bit (tensor-core) kernels at the edges of their 64-row tiles
    and of the decode splits, and in f16, against their plain versions."""
    import torch
    flash, decode = fmod.flash_attention_cuda, dmod.decode_attention_cuda
    f_plain, d_plain = fmod.flash_attention_plain, dmod.decode_attention_plain
    cases = [attn_compare(flash, f_plain,
                          attn_inputs((2, 8, s_len, 128), "bfloat16", gen),
                          {"causal": True}, f"flash: S = {s_len}, tile edge",
                          "bfloat16")
             for s_len in (63, 64, 65, 129)]
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, 1000, 128), "bfloat16",
                                          gen),
                              {"causal": True, "window": 100},
                              "flash: window 100, its edge across tiles",
                              "bfloat16"))
    cases.append(attn_compare(flash, f_plain,
                              attn_inputs((1, 8, 2048, 128), "float16", gen),
                              {"causal": True}, "flash: f16", "float16"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tile = dmod.TILE

    def lens_at(b, n_kv, s_len, edges):
        """lens one below, at and one above each edge (the splits' own
        among them), then 1 and s_len, cycled over the batch."""
        chunk, _ = dmod.split_plan(b, n_kv, s_len, n_sm)
        vals = list(dict.fromkeys(
            [e + o for e in (*edges, chunk, 2 * chunk) for o in (-1, 0, 1)
             if 1 <= e + o <= s_len] + [1, s_len]))
        return torch.tensor([vals[i % len(vals)] for i in range(b)],
                            dtype=torch.int32, device=DEV)

    for b, n_kv, group, s_len, edges, label in (
            (16, 4, 8, 4160, (tile, 2 * tile, 3 * tile),
             "splits of a few tiles"),
            (12, 4, 8, 32768, (4096,), "splits that wrap the ring"),
            (8, 8, 1, 1000, (tile,), "group 1"),
            (8, 4, 5, 1000, (tile,), "group 5"),
            (8, 2, 16, 2048, (tile,), "group 16")):
        args = decode_inputs(b, n_kv, group, s_len, "bfloat16", gen,
                             lens=lens_at(b, n_kv, s_len, edges))
        case = attn_compare(decode, d_plain, args, {},
                            f"decode: lens at tile and split edges, {label}",
                            "bfloat16")
        case["lens"] = args[3].tolist()
        cases.append(case)
    cases.append(attn_compare(decode, d_plain,
                              decode_inputs(8, 4, 8, 4096, "float16", gen),
                              {}, "decode: f16", "float16"))
    return cases


def f64_lm_forward(cfg, params, tokens):
    """The dense GQA stack in float64 with plain torch ops, written from the
    architecture (RMSNorm with 1 + scale, RoPE on halves, causal softmax
    attention with KV heads repeated, SwiGLU), not from the port's code."""
    import torch
    import torch.nn.functional as F

    def w(t):
        return t.to(torch.float64)

    def norm(x, scale):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) \
            * (1.0 + w(scale))

    b, s = tokens.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    inv = cfg.rope_theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                           device=DEV) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=DEV)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)

    def rope(t):
        t1, t2 = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], -1)

    causal = torch.ones((s, s), dtype=torch.bool, device=DEV).tril()
    x = w(params["embed"])[tokens]
    for p in params["layers"]:
        a, m = p["attn"], p["mlp"]
        h = norm(x, p["ln1"])
        q = rope((h @ w(a["wq"])).view(b, s, hq, hd).transpose(1, 2))
        k = rope((h @ w(a["wk"])).view(b, s, hkv, hd).transpose(1, 2))
        v = (h @ w(a["wv"])).view(b, s, hkv, hd).transpose(1, 2)
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), -1)
        o = (att @ v).transpose(1, 2).reshape(b, s, hq * hd)
        x = x + o @ w(a["wo"])
        h = norm(x, p["ln2"])
        x = x + (F.silu(h @ w(m["w_gate"])) * (h @ w(m["w_up"]))) \
            @ w(m["w_down"])
    return norm(x, params["final_norm"]) @ w(params["lm_head"])


def teacher_forced(cfg, params, tokens):
    """decode_step over every position of `tokens`; logits (B, S, V)."""
    import torch
    from repro_torch.models import decode_step, init_decode_state
    b, s = tokens.shape
    state = init_decode_state(cfg, b, s, device=DEV)
    out = []
    for t in range(s):
        logits, state = decode_step(cfg, params, tokens[:, t:t + 1], state)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def zero_attn_counts(fmod, dmod) -> None:
    """The attention kernels' launch counts, in all and by route, to 0."""
    fmod.FLASH_LAUNCHES = dmod.DECODE_LAUNCHES = 0
    for routes in (fmod.FLASH_ROUTE_LAUNCHES, dmod.DECODE_ROUTE_LAUNCHES):
        for route in routes:
            routes[route] = 0


def attn_counts(fmod, dmod) -> dict:
    return {"flash": fmod.FLASH_LAUNCHES,
            "flash_routes": dict(fmod.FLASH_ROUTE_LAUNCHES),
            "decode": dmod.DECODE_LAUNCHES,
            "decode_routes": dict(dmod.DECODE_ROUTE_LAUNCHES)}


def check_routes(label: str, counts: dict, kernel: str, route: str) -> None:
    """Every launch of `kernel` counted in `counts` took `route`."""
    routes = counts[f"{kernel}_routes"]
    if routes[route] != counts[kernel] or sum(routes.values()) != counts[
            kernel]:
        raise AssertionError(f"{label}: {kernel} launches by route {routes}, "
                             f"want all {counts[kernel]} on {route}")


def phase_lm_check(fmod, dmod, seed: int) -> dict:
    """4-layer float32 Yi-6B width: forward and teacher-forced decode
    against float64; returns the launches of each."""
    import torch
    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(CONFIG, n_layers=4, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    params = init_params(cfg, gen, device=DEV)
    tokens = torch.randint(0, cfg.vocab, (2, LM_PROMPT), device=DEV,
                           generator=gen)
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # forward starts
        logits, _ = forward(cfg, params, tokens)
        fwd_counts = attn_counts(fmod, dmod)             # ... and ends here
        zero_attn_counts(fmod, dmod)                     # decode starts
        dec = teacher_forced(cfg, params, tokens)
        dec_counts = attn_counts(fmod, dmod)             # ... and ends here
        sync()
        ref = f64_lm_forward(cfg, params, tokens)
    flash, decode = fwd_counts["flash"], dec_counts["decode"]
    errs = {"forward": rel_err(logits, ref), "decode": rel_err(dec, ref)}
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    if (flash, fwd_counts["decode"], dec_counts["flash"], decode) != (
            cfg.n_layers, 0, 0, cfg.n_layers * LM_PROMPT):
        raise AssertionError(f"lm_check launches: forward {fwd_counts}, "
                             f"decode {dec_counts}; want flash "
                             f"{cfg.n_layers}, decode "
                             f"{cfg.n_layers * LM_PROMPT}")
    check_routes("lm_check forward", fwd_counts, "flash", "f32_fma")
    check_routes("lm_check decode", dec_counts, "decode", "f32_fma")
    bad = {k: e for k, e in errs.items() if not e <= LM_REL_TOL}
    if bad:
        raise AssertionError(f"lm_check: relative error above {LM_REL_TOL}: "
                             f"{bad}")
    emit({"phase": "lm_check", "config": "yi-6b width, 4 layers, float32",
          "batch": 2, "tokens": LM_PROMPT,
          "rel_err_vs_float64": errs, "tol": LM_REL_TOL,
          "argmax_agreement_decode_vs_float64": agree,
          "flash_launches": flash, "decode_launches": decode,
          "launches_by_route": {"flash": fwd_counts["flash_routes"],
                                "decode": dec_counts["decode_routes"]},
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    del params, logits, dec, ref
    torch.cuda.empty_cache()
    return {"flash": flash, "decode": decode,
            "flash_routes": fwd_counts["flash_routes"],
            "decode_routes": dec_counts["decode_routes"]}


def profile_decode(cfg, params) -> dict:
    """torch.profiler over PROFILED_STEPS decode steps at serve's batch
    (outside the counted runs): kernels launched and device busy time per
    step, from the trace's device events; the busy share of wall time
    needs the unprofiled step time beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, init_decode_state
    state = init_decode_state(cfg, LM_BATCH, LM_PROMPT + LM_STEPS + 1,
                              device=DEV)
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=DEV)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            _, state = decode_step(cfg, params, tok, state)
        sync()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": PROFILED_STEPS,
            "kernels_per_step": len(kernels) / PROFILED_STEPS,
            "device_busy_ms_per_step": busy_us / 1e3 / PROFILED_STEPS,
            "top_kernels_ms_per_step": {
                name[:80]: us / 1e3 / PROFILED_STEPS for name, us in top}}


def phase_lm_serve(fmod, dmod, seed: int) -> dict:
    """Full Yi-6B in bf16: serve, prefill forward, and decode against the
    forward; returns the launches of each path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import (
        decode_step, forward, init_decode_state, init_params, param_count,
    )

    cfg = get_config("yi_6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(seed),
                         device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, size=(LM_BATCH, LM_PROMPT),
                           dtype=np.int32)
    with torch.inference_mode():                     # warm-up, not counted
        decode_step(cfg, params, torch.zeros((LM_BATCH, 1), dtype=torch.long,
                                             device=DEV),
                    init_decode_state(cfg, LM_BATCH, 2, device=DEV))
    sync()

    zero_attn_counts(fmod, dmod)                     # serve starts here
    t0 = time.perf_counter()
    tokens = serve(cfg, params, prompts, steps=LM_STEPS)
    sync()
    serve_s = time.perf_counter() - t0
    serve_counts = attn_counts(fmod, dmod)           # ... and ends here
    serve_launches = {"flash": serve_counts["flash"],
                      "decode": serve_counts["decode"]}
    serve_peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (LM_PROMPT + LM_STEPS)
    if serve_launches != {"flash": 0, "decode": want}:
        raise AssertionError(f"serve launches {serve_launches}, want decode "
                             f"{want}")
    check_routes("lm_serve serve", serve_counts, "decode", "tensor_core")
    if tokens.shape != (LM_BATCH, LM_STEPS) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"serve tokens {tokens.shape} out of range")

    profile = profile_decode(cfg, params)

    seq = np.concatenate([prompts[:1], rng.integers(
        0, cfg.vocab, size=(1, LM_PREFILL - LM_PROMPT), dtype=np.int32)], 1)
    seq = torch.from_numpy(seq).long().to(DEV)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        zero_attn_counts(fmod, dmod)                     # prefill starts
        sync()
        t0 = time.perf_counter()
        logits, _ = forward(cfg, params, seq)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_counts = attn_counts(fmod, dmod)         # ... and ends here
        prefill_flash = prefill_counts["flash"]
        prefill_peak = torch.cuda.max_memory_allocated()
        if prefill_flash != cfg.n_layers or prefill_counts["decode"] != 0:
            raise AssertionError(f"prefill flash launches {prefill_flash}, "
                                 f"want {cfg.n_layers}")
        check_routes("lm_serve prefill", prefill_counts, "flash",
                     "tensor_core")
        if logits.shape != (1, LM_PREFILL, cfg.vocab) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 "not finite")
        zero_attn_counts(fmod, dmod)                 # cross-check starts
        dec = teacher_forced(cfg, params, seq[:, :LM_PROMPT])
        cross_counts = attn_counts(fmod, dmod)       # ... and ends here
        cross_decode = cross_counts["decode"]
    fwd = logits[:, :LM_PROMPT]
    gap = rel_err(dec, fwd)
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    if cross_decode != cfg.n_layers * LM_PROMPT:
        raise AssertionError(f"cross-check decode launches {cross_decode}")
    check_routes("lm_serve cross-check", cross_counts, "decode",
                 "tensor_core")
    if not gap <= LM_BF16_TOL:
        raise AssertionError(f"decode vs forward logits: relative gap {gap} "
                             f"> {LM_BF16_TOL}")
    emit({"phase": "lm_serve", "config": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "params": param_count(params),
          "init_s": init_s,
          "serve": {"batch": LM_BATCH, "prompt": LM_PROMPT,
                    "steps": LM_STEPS, "seconds": serve_s,
                    "generated_tokens_per_s": LM_BATCH * LM_STEPS / serve_s,
                    "processed_tokens_per_s":
                        LM_BATCH * (LM_PROMPT + LM_STEPS) / serve_s,
                    "ms_per_decode_step":
                        1e3 * serve_s / (LM_PROMPT + LM_STEPS),
                    "launches": serve_launches,
                    "decode_launches_by_route":
                        serve_counts["decode_routes"],
                    "peak_allocated_bytes": serve_peak,
                    "first_tokens": tokens[:, :8].tolist(),
                    "profiled_decode_steps": profile},
          "prefill": {"tokens": LM_PREFILL, "seconds": prefill_s,
                      "tokens_per_s": LM_PREFILL / prefill_s,
                      "flash_launches": prefill_flash,
                      "flash_launches_by_route":
                          prefill_counts["flash_routes"],
                      "peak_allocated_bytes": prefill_peak},
          "decode_vs_forward": {"positions": LM_PROMPT,
                                "rel_gap": gap, "tol": LM_BF16_TOL,
                                "argmax_agreement": agree,
                                "decode_launches": cross_decode}})
    del params, logits, dec, fwd
    torch.cuda.empty_cache()
    return {"flash": prefill_flash, "decode": serve_launches["decode"],
            "decode_crosscheck": cross_decode,
            "flash_routes": prefill_counts["flash_routes"],
            "decode_routes": {r: serve_counts["decode_routes"][r]
                              + cross_counts["decode_routes"][r]
                              for r in serve_counts["decode_routes"]}}


def time_flash(fmod, seed: int) -> dict:
    """The flash kernel at Yi-6B's per-layer prefill (train_4k length), its
    plain version and SDPA (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    b, h, s_len, d = 1, 32, LM_PREFILL, 128
    q, k, v = attn_inputs((b, h, s_len, d), "bfloat16", gen)
    ms = cuda_ms(lambda: fmod.flash_attention_cuda(q, k, v, causal=True), 10)
    plain_ms = cuda_ms(lambda: fmod.flash_attention_plain(q, k, v,
                                                          causal=True),
                       3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    pairs = b * h * s_len * (s_len + 1) // 2        # causal (query, key)
    flops = 4.0 * d * pairs
    nbytes = 4 * b * h * s_len * d * q.element_size()   # q, k, v, out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"shape": [b, h, s_len, d], "dtype": "bfloat16", "causal": True,
            "flops": flops, "min_bytes": nbytes, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention(is_causal=True)",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_f32_fma": 1e3 * flops / PEAK_F32_FLOPS,
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms}


def device_ms(fn, repeats: int) -> float:
    """Device time per call of `fn`, which launches each of its kernels
    once: the mean duration of each kernel over a torch.profiler trace of
    `repeats` calls, summed over the kernels. Unlike cuda_ms it leaves out
    the gaps in which the card waits for the host; the mean, not the sum
    over `repeats`, because the trace may miss a call's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        sync()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return sum(sum(us) / len(us) for us in by_name.values()) / 1e3


def time_decode(dmod, seed: int, b: int, s_len: int,
                repeats: int = 10) -> dict:
    """The decode kernels at one layer's shape, every cache full (Yi-6B's 4
    KV heads of 8 query heads), their plain version and SDPA with
    enable_gqa (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    n_kv, group, d = 4, 8, 128
    lens = torch.full((b,), s_len, dtype=torch.int32, device=DEV)
    q, k, v, lens = decode_inputs(b, n_kv, group, s_len, "bfloat16", gen,
                                  lens=lens)
    ms = cuda_ms(lambda: dmod.decode_attention_cuda(q, k, v, lens), repeats)
    dev_ms = device_ms(lambda: dmod.decode_attention_cuda(q, k, v, lens),
                       repeats)
    plain_ms = cuda_ms(lambda: dmod.decode_attention_plain(q, k, v, lens), 2,
                       warmup=1)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q_sdpa = q.reshape(b, n_kv * group, 1, d)
    # Not the math backend: it would repeat K and V to 32 heads (68 GB).
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q_sdpa, k, v, enable_gqa=True), 10)
    n_valid = int(lens.long().sum())
    nbytes = (2 * n_valid * n_kv * d * k.element_size()        # K, V rows
              + 2 * q.numel() * q.element_size() + lens.numel() * 4)
    flops = 4.0 * n_valid * n_kv * group * d
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"q": list(q.shape), "kv": list(k.shape), "dtype": "bfloat16",
            "lens": s_len, "splits": list(dmod.split_plan(
                b, n_kv, s_len,
                torch.cuda.get_device_properties(0).multi_processor_count)),
            "flops": flops, "min_bytes": nbytes, "ms": ms,
            "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention(enable_gqa=True)",
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms,
            "achieved_bytes_per_s": nbytes / (ms * 1e-3)}


def phase_timing(kmod, fmod, dmod, plans, h_main, h_lj, h_train, g_train,
                 seed: int) -> dict:
    import torch
    from repro_torch.configs import SHAPES
    torch.cuda.reset_peak_memory_stats()
    lj = plans["lj_serve"]
    timing = {
        "bcsr_spmm": time_spmm(kmod, plans["serve"]["ell"],
                               plans["serve"]["csr"], h_main),
        "bcsr_spmm_socLJ1": time_spmm(kmod, lj["ell"], lj["csr"], h_lj),
        "bcsr_spmm_transposed": time_spmm(kmod, plans["bwd"]["ell"],
                                          plans["bwd"]["csr"], g_train),
        "fused_gcn_layer": time_fused(kmod, plans["fwd"]["ell"],
                                      plans["fwd"]["csr"], h_train,
                                      h_train.shape[1]),
        "flash_attention": time_flash(fmod, seed),
        "decode_attention": time_decode(dmod, seed,
                                        SHAPES["decode_32k"]["global_batch"],
                                        SHAPES["decode_32k"]["seq_len"]),
        # lm_serve's cache at its longest (serve's max_len).
        "decode_attention_lm_serve": time_decode(
            dmod, seed, LM_BATCH, LM_PROMPT + LM_STEPS + 1, repeats=200),
    }
    emit({"phase": "timing", **timing,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    return timing


def first_segment(plan, a_streamed) -> dict:
    """Segment 0 of a stream plan: its bricks and its rows of the streamed
    matrix as a CSR."""
    from repro_torch.sparse import csr_row_slice
    seg = plan.robw.segments[0]
    return {"ell": plan.stream_payloads()[0][1],
            "csr": csr_row_slice(a_streamed, seg.row_start, seg.row_end),
            "segments": [list(e.blocks.shape)
                         for _, e in plan.stream_payloads()]}


def run(args) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls sum in f32 throughout (no reduced-precision split-K).
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "tf32": "off (matmul and cudnn)",
          "bf16_reduced_precision_reduction": "off",
          "scales": {"rUSA": args.rusa_scale, "socLJ1": args.lj_scale}})

    from repro_torch.kernels import bcsr_spmm as kmod
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.kernels import flash_attn as fmod
    info = kmod.build()
    emit({"phase": "build", "seconds": info.seconds,
          "library": str(info.library.relative_to(ROOT)),
          "ptxas": ptxas_table(info.ptxas)})

    t0 = time.perf_counter()
    # Seeds follow launch/serve.py: graphs in ("socLJ1", "rUSA") order.
    graphs = {"rUSA": paper_graph("rUSA", args.rusa_scale, 1),
              "socLJ1": paper_graph("socLJ1", args.lj_scale, 0)}
    a = graphs["rUSA"]
    width, train_width = 1024, 256
    shape, train_shape = (a.n_rows, width), (a.n_rows, train_width)
    serve_eng, train_eng = engine_at(a, width), engine_at(
        a, train_width)
    lj = graphs["socLJ1"]
    plans = {"serve": first_segment(serve_eng.stream_plan(a, shape), a),
             "lj_serve": first_segment(engine_at(lj, width).stream_plan(
                 lj, (lj.n_rows, width)), lj),
             "fwd": first_segment(train_eng.stream_plan(a, train_shape), a),
             "bwd": first_segment(train_eng.stream_plan(
                 a, train_shape, transpose=True), train_eng.transpose_of(a))}
    emit({"phase": "host", "seconds": time.perf_counter() - t0,
          "segments": {k: v["segments"] for k, v in plans.items()}})
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    h_main = torch.randn(shape, device=DEV, generator=gen)
    h_train = torch.randn(train_shape, device=DEV, generator=gen)
    g_train = torch.randn(train_shape, device=DEV, generator=gen)
    h_lj = torch.randn((lj.n_rows, width), device=DEV, generator=gen)

    spmm_err = phase_kernel(kmod, plans["serve"]["ell"], h_main,
                            plans["bwd"]["ell"], g_train,
                            plans["lj_serve"]["ell"], h_lj)
    fused_err = phase_fused(kmod, plans["fwd"]["ell"], h_train)
    launches = {"serve": phase_serve(kmod, graphs, args)}
    a64 = f64_adjacency(a)
    fused_launches, launches["layer"] = phase_layer(kmod, train_eng, a, a64,
                                                    args.seed)
    launches["train"] = phase_train(kmod, train_eng, a, a64, args.seed)
    attn_err = phase_attn(fmod, dmod, args.seed)
    lm = {"lm_check": phase_lm_check(fmod, dmod, args.seed),
          "lm_serve": phase_lm_serve(fmod, dmod, args.seed)}
    timing = phase_timing(kmod, fmod, dmod, plans, h_main, h_lj, h_train,
                          g_train, args.seed)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    gcn_keys = (*keys, "bound_ms_bricks", "bound_by_bricks")

    def gcn_by_route(kernel: str) -> dict:
        routes = [path[kernel] for path in GCN_ROUTES.values()]
        return {route: sum(r[route] for r in routes) for route in routes[0]}

    flash_paths = {"lm_check": lm["lm_check"]["flash"],
                   "lm_serve_prefill": lm["lm_serve"]["flash"]}

    def by_route(kernel: str) -> dict:
        return {route: sum(path[f"{kernel}_routes"][route]
                           for path in lm.values())
                for route in ("tensor_core", "f32_fma")}

    decode_paths = {"lm_check": lm["lm_check"]["decode"],
                    "lm_serve": lm["lm_serve"]["decode"],
                    "lm_serve_crosscheck":
                        lm["lm_serve"]["decode_crosscheck"]}
    emit({"kernels": [
        {"name": "bcsr_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
         "replaces": "src/repro/kernels/bcsr_spmm.py:50",
         "launches": sum(launches.values()), "launches_by_path": launches,
         "launches_by_route": gcn_by_route("bcsr_spmm"),
         "max_abs_err": spmm_err,
         **{k: timing["bcsr_spmm"][k] for k in gcn_keys},
         "transposed": {k: timing["bcsr_spmm_transposed"][k]
                        for k in gcn_keys},
         "socLJ1": {k: timing["bcsr_spmm_socLJ1"][k] for k in gcn_keys}},
        {"name": "fused_gcn_layer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_gcn_layer.cu",
         "replaces": "src/repro/kernels/bcsr_spmm.py:127",
         "launches": fused_launches,
         "launches_by_path": {"layer": fused_launches},
         "launches_by_route": gcn_by_route("fused_gcn_layer"),
         "max_abs_err": fused_err,
         **{k: timing["fused_gcn_layer"][k] for k in (
             *gcn_keys, "bound_ms_split_tf32", "bound_by_split_tf32")},
         "yardstick_ms": timing["fused_gcn_layer"]["yardstick_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn.py:87",
         "launches": sum(flash_paths.values()),
         "launches_by_path": flash_paths,
         "launches_by_route": by_route("flash"),
         "max_abs_err": attn_err["flash"],
         **{k: timing["flash_attention"][k] for k in keys},
         "bound_ms_f32_fma": timing["flash_attention"]["bound_ms_f32_fma"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:68",
         "launches": sum(decode_paths.values()),
         "launches_by_path": decode_paths,
         "launches_by_route": by_route("decode"),
         "max_abs_err": attn_err["decode"],
         **{k: timing["decode_attention"][k] for k in keys},
         "lm_serve_shape": {k: timing["decode_attention_lm_serve"][k]
                            for k in (*keys, "device_ms")}}]})
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
