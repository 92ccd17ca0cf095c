"""Time the fused GCN-layer kernel's X·W on the tensor cores against X·W on
f32 FMA, on one CUDA card.

    PYTHONPATH=src python scripts/fused_variants.py [--repeats 20]

`split_tf32` is the checkout's kernel as the port calls it (route
"grouped": three TF32 `mma.sync` products, hi·hi + hi·lo + lo·hi);
`f32_fma` is `scripts/fused_xw_fma.cu`, the same kernel with X·W on f32 FMA
over the shared W chunk, built by nvcc beside a copy of
`kernels/csrc/block_ell.cuh` into the gitignored `kernels/build/variants/`
and loaded with ctypes. Both are timed with CUDA events at chip_smoke.py's
training segment (rUSA 1e-2 forward segment 0, F = 256, F_out = 256 and
64), each after a check against the plain version within chip_smoke.py's
MAIN_TOL, and again with every n_tiles set to 0 (`xw_only`: no slot is
aggregated, X stays 0, so the time is the W stream, X·W and the store; not
checked). Prints one JSON line per variant, width and probe (with ptxas's
registers and spills for the FMA variant), two rounds in turn, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

from repro_torch.kernels import bcsr_spmm as kmod  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def build_fma_variant():
    """`fused_xw_fma_launch` of scripts/fused_xw_fma.cu, and ptxas's lines
    for its kernel."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(build.CSRC / "block_ell.cuh", out_dir / "block_ell.cuh")
    shutil.copy(Path(__file__).with_name("fused_xw_fma.cu"),
                out_dir / "fused_xw_fma.cu")
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
         str(out_dir / "fused_xw_fma.so"), str(out_dir / "fused_xw_fma.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"fused_xw_fma.cu failed to build:\n{proc.stdout}")
    fn = ctypes.CDLL(str(out_dir / "fused_xw_fma.so")).fused_xw_fma_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, [row for row in cs.ptxas_table(proc.stdout)
                if "fused_fma_kernel" in row]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_variants.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    kmod.build()
    fma, fma_ptxas = build_fma_variant()

    a = cs.paper_graph("rUSA", 1e-2, 1)
    eng = cs.engine_at(a, 256)
    seg = cs.first_segment(eng.stream_plan(a, (a.n_rows, 256)), a)
    ell = seg["ell"]
    bricks = cs.brick_tensors(ell)
    no_slots = [bricks[0], bricks[1], torch.zeros_like(bricks[2])]
    gen = torch.Generator(device="cuda").manual_seed(4)
    h = torch.randn((a.n_rows, 256), device="cuda", generator=gen)

    def split_tf32(operands, w, b):
        return kmod.fused_gcn_layer_cuda(*operands, h, w, b, bm=ell.bm,
                                         bk=ell.bk)

    def f32_fma(operands, w, b):
        n_rb, ell_w = operands[0].shape[:2]
        out = torch.empty((n_rb * ell.bm, w.shape[1]), device="cuda")
        err = fma(*(t.data_ptr() for t in (*operands, h, w, b, out)), n_rb,
                  ell_w, ell.bm, ell.bk, h.shape[0], h.shape[1], w.shape[1],
                  torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    cases = []
    for f_out in (256, 64):
        w = torch.randn((256, f_out), device="cuda", generator=gen) / 16.0
        b = 0.1 * torch.randn((f_out,), device="cuda", generator=gen)
        plain = kmod.fused_gcn_layer_plain(*bricks, h, w, b, bm=ell.bm,
                                           bk=ell.bk)
        cases.append((f_out, w, b, plain))
    _, route = cs.launch_route(kmod.FUSED_ROUTE_LAUNCHES, lambda: split_tf32(
        bricks, cases[0][1], cases[0][2]))
    if route != "grouped":
        raise AssertionError(f"the training segment took route {route}")

    variants = {"split_tf32": (split_tf32, None), "f32_fma": (f32_fma,
                                                              fma_ptxas)}
    for rnd in range(2):
        for name, (fn, ptxas) in variants.items():
            for f_out, w, b, plain in cases:
                err = float((fn(bricks, w, b) - plain).abs().max())
                if not err <= cs.MAIN_TOL:
                    raise AssertionError(f"{name}, F_out={f_out}: |kernel - "
                                         f"plain| {err}")
                for probe, operands in (("", bricks), ("xw_only", no_slots)):
                    ms = cs.cuda_ms(lambda: fn(operands, w, b), args.repeats)
                    print(json.dumps({
                        "round": rnd, "variant": name,
                        "probe": probe or None, "f_out": f_out, "ms": ms,
                        "max_abs_err": None if probe else err,
                        "ptxas": ptxas}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
