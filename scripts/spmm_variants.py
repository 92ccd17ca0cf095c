"""Locate the time of the zero-skipping Block-ELL SpMM on one CUDA card.

    PYTHONPATH=src python scripts/spmm_variants.py [--repeats 20]

Builds chip_smoke.py's segments (rUSA 1e-2 serving segment 0, the training
plan's transposed segment 0, socLJ1 1e-3 serving segment 0), each at
F = 256 and 1024, and times with CUDA events:

  full         the checkout's kernel as the port calls it (both kernels
               where the segment has row blocks longer than 64 slots);
  first_only   n_tiles cut to 64, so the first kernel does all the work
               and the second finds no long row block (a timing probe, its
               output is not the product);
  compact64    the first kernel alone on the bricks copied to ell_w = 64
               (the same first 64 slots, 64 slots apart instead of ell_w):
               the cost of the segment's row-block stride;
  cpl{C}_u{U}  `full` built with COLS_PER_LANE = C (feature columns per
               lane: a warp covers 32*C) and UNROLL = U (H rows in flight)
               in csrc/block_ell.cuh, each variant by its own nvcc (all
               started together) into the gitignored `kernels/build/
               variants/`; cpl8_u4 is the source's;
  sparse_mm    torch.sparse.mm on the segment's CSR (a yardstick).

Every variant's output is first held against the plain version within
chip_smoke.py's REL_TOL of its scale. Prints one JSON line per segment and
width, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

kmod = importlib.import_module("repro_torch.kernels.bcsr_spmm")
from repro_torch.kernels import build  # noqa: E402

VARIANTS = [(8, 4), (4, 4), (4, 8), (8, 2)]   # (COLS_PER_LANE, UNROLL)


def build_variants() -> dict:
    """{name: the variant library's bcsr_spmm_launch}."""
    src = (build.CSRC / "bcsr_spmm.cu").read_text()
    header = (build.CSRC / "block_ell.cuh").read_text()
    nvcc = build._nvcc()
    procs = {}
    for cpl, unroll in VARIANTS:
        name = f"cpl{cpl}_u{unroll}"
        d = build.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        h = header
        for const, value in (("COLS_PER_LANE", cpl), ("UNROLL", unroll)):
            h, n = re.subn(rf"constexpr int {const} = \d+;",
                           f"constexpr int {const} = {value};", h, count=1)
            if n != 1:
                raise ValueError(f"no constant {const} in block_ell.cuh")
        (d / "block_ell.cuh").write_text(h)
        (d / "bcsr_spmm.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "bcsr_spmm.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{report}")
        fn = ctypes.CDLL(str(build.BUILD_DIR / "variants" / name / "lib.so")
                         ).bcsr_spmm_launch
        fn.argtypes = kmod._spmm_fn().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, args, h, bm, bk):
    """One launch through `fn`, a variant library's bcsr_spmm_launch, which
    must take the zero-skipping route."""
    blocks, col_tile, n_tiles = args
    n_rb, ell_w = blocks.shape[:2]
    out = torch.empty((n_rb * bm, h.shape[1]), device=h.device)
    tail = torch.empty((1 + n_rb,), dtype=torch.int32, device=h.device)
    route = ctypes.c_int(-1)
    err = fn(blocks.data_ptr(), col_tile.data_ptr(), n_tiles.data_ptr(),
             h.data_ptr(), out.data_ptr(), tail.data_ptr(), n_rb, ell_w, bm,
             bk, h.shape[0], h.shape[1], 0, kmod._DTYPE_CODES[blocks.dtype],
             kmod._DTYPE_CODES[h.dtype],
             torch.cuda.current_stream().cuda_stream, ctypes.addressof(route))
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    if route.value != kmod.SPMM_ROUTES.index("zero_skip"):
        raise AssertionError(f"the variant took route {route.value}")
    return out


def segment_row(label, ell, csr, h, fns, repeats):
    args = cs.brick_tensors(ell)
    bm, bk = ell.bm, ell.bk
    plain = kmod.bcsr_spmm_plain(*args, h, bm=bm, bk=bk)
    scale = float(plain.abs().max())
    row = {"segment": label, "blocks": list(ell.blocks.shape),
           "h": list(h.shape), "long_row_blocks": int((args[2] > 64).sum()),
           "max_n_tiles": int(args[2].max())}
    for name, fn in fns.items():
        err = float((launch(fn, args, h, bm, bk) - plain).abs().max())
        if not err <= cs.REL_TOL * scale:
            raise AssertionError(f"{label}, {name}: |kernel - plain| {err}")
    del plain
    first = [args[0], args[1], torch.clamp(args[2], max=64)]
    compact = [args[0][:, :64].contiguous(), args[1][:, :64].contiguous(),
               first[2]]
    a_csr = cs.csr_on_card(csr)
    src = fns["cpl8_u4"]
    probes = {
        "full": lambda: kmod.bcsr_spmm_cuda(*args, h, bm=bm, bk=bk),
        "first_only": lambda: launch(src, first, h, bm, bk),
        "compact64": lambda: launch(src, compact, h, bm, bk),
        **{name: (lambda fn=fn: launch(fn, args, h, bm, bk))
           for name, fn in fns.items()},
        "sparse_mm": lambda: torch.sparse.mm(a_csr, h)}
    for name, fn in probes.items():
        row[f"{name}_ms"] = cs.cuda_ms(fn, repeats)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmm_variants.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    kmod.build()
    fns = build_variants()
    rusa = cs.paper_graph("rUSA", 1e-2, 1)
    lj = cs.paper_graph("socLJ1", 1e-3, 0)
    train = cs.engine_at(rusa, 256)
    segs = {
        "rUSA serving 0": cs.first_segment(cs.engine_at(rusa, 1024)
                                           .stream_plan(rusa, (rusa.n_rows,
                                                               1024)), rusa),
        "rUSA transposed 0": cs.first_segment(
            train.stream_plan(rusa, (rusa.n_rows, 256), transpose=True),
            train.transpose_of(rusa)),
        "socLJ1 serving 0": cs.first_segment(cs.engine_at(lj, 1024)
                                             .stream_plan(lj, (lj.n_rows,
                                                               1024)), lj)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, seg in segs.items():
        for f in (1024, 256):
            h = torch.randn((seg["csr"].shape[1], f), device="cuda",
                            generator=gen)
            print(json.dumps(segment_row(label, seg["ell"], seg["csr"], h,
                                         fns, args.repeats)), flush=True)
            del h
            torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
