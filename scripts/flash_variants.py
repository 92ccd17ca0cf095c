"""Time variants of the 16-bit flash-attention kernel's tile constants on
one CUDA card.

    PYTHONPATH=src python scripts/flash_variants.py [--repeats 20]

Each variant is the checkout's `kernels/csrc/flash_attn.cu` with the
tensor-core kernel's WARPS (16 query rows each), STAGES (K/V tiles in the
ring), MIN_BLOCKS (blocks per SM, which caps the registers) and BK (keys
per tile) replaced, built by its own nvcc (all started together) into the
gitignored `kernels/build/variants/`, loaded with ctypes and timed with CUDA
events at Yi-6B's per-layer prefill, q, k, v (1, 32, 4096, 128) bf16
causal, after a check against the plain version within the card tests'
bf16 limit. The first variant is the source as it stands. Prints one JSON
line per variant (with ptxas's registers and spills), two rounds in turn,
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attn as fmod

VARIANTS = [  # (WARPS, STAGES, MIN_BLOCKS, BK); the first is the source's
    (8, 2, 1, 64), (8, 3, 1, 64), (4, 2, 2, 64), (4, 3, 2, 64),
    (4, 2, 2, 32), (4, 2, 3, 32), (4, 3, 3, 32)]
RTOL, ATOL = 2.0 ** -7, 4e-6          # bf16, as tests/test_torch_gpu.py


def variant_source(source: str, warps: int, stages: int, min_blocks: int,
                   bk: int) -> str:
    """The tensor-core kernel's constants replaced (namespace tc only)."""
    head, tc = source.split("namespace tc {", 1)
    for name, value in (("WARPS", warps), ("STAGES", stages),
                        ("MIN_BLOCKS", min_blocks), ("BK", bk)):
        tc, n = re.subn(rf"constexpr int {name} = \d+;",
                        f"constexpr int {name} = {value};", tc, count=1)
        if n != 1:
            raise ValueError(f"no constant {name} in the tensor-core kernel")
    return head + "namespace tc {" + tc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants.py: no CUDA device", file=sys.stderr)
        return 2
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "attention.cuh").write_text(
        (build.CSRC / "attention.cuh").read_text())
    source = (build.CSRC / "flash_attn.cu").read_text()
    nvcc = build._nvcc()
    procs = []
    for i, v in enumerate(VARIANTS):
        src = out_dir / f"flash_{i}.cu"
        src.write_text(variant_source(source, *v))
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"flash_{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = [p.communicate()[0] for p in procs]

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 32, 4096, 128), device="cuda",
                           generator=gen).bfloat16() for _ in range(3))
    plain = fmod.flash_attention_plain(q, k, v, causal=True)
    entries = []
    for i, (v_, proc, report) in enumerate(zip(VARIANTS, procs, reports)):
        if proc.returncode != 0:
            raise RuntimeError(f"variant {v_} failed to build:\n{report}")
        # ptxas's lines for the bf16 instance at d = 128 (NC = 8).
        props, entry = [], None
        for ln in report.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
            elif entry and "2tc17flash_attn_kernelI13__nv_bfloat16Li8ELb0E" \
                    in entry and ("Used" in ln or "spill" in ln):
                props.append(ln.split(":", 1)[-1].strip())
        fn = ctypes.CDLL(str(out_dir / f"flash_{i}.so")).flash_attn_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries.append((v_, fn, props))

    def call(fn):
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None, *q.shape, 1, 0, q.shape[3] ** -0.5, 0.0,
                 fmod.DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    for rnd in range(2):
        for (warps, stages, min_blocks, bk), fn, props in entries:
            out = call(fn)
            delta = (out.float() - plain.float()).abs()
            ratio = float((delta / (RTOL * plain.float().abs() + ATOL)).max())
            if not ratio <= 1.0:
                raise AssertionError(f"variant {warps, stages, min_blocks, bk}"
                                     f": |Δ| over the limit by {ratio}")
            for _ in range(3):
                call(fn)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.repeats):
                call(fn)
            end.record()
            torch.cuda.synchronize()
            print(json.dumps({"round": rnd, "warps": warps, "stages": stages,
                              "min_blocks": min_blocks, "bk": bk,
                              "ms": start.elapsed_time(end) / args.repeats,
                              "max_err_over_limit": ratio,
                              "ptxas": props}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
