"""Time variants of the 16-bit flash-attention backward's tile constants on
one CUDA card, kernel by kernel.

    PYTHONPATH=src python scripts/flash_bwd_variants.py [--repeats 10]

Each variant is the checkout's `kernels/csrc/flash_attn_bwd.cu` with the
tensor-core kernels' WARPS (16 owned rows each), TILE (streamed rows a ring
stage holds, equal to the owned rows), CHUNK (streamed rows a register
pass takes) and MIN_BLOCKS (blocks per SM, which caps the registers)
replaced, built by its own nvcc (all started together) into the gitignored
`kernels/build/bwd_variants/`, loaded with ctypes, checked against
`flash_attention_bwd_plain` within the card tests' bf16 limit (BWD_TOL)
and timed at lm_train's microbatch (4, 32, 512, 128) and Yi-6B's prefill
(1, 32, 4096, 128), bf16 causal: CUDA events over `--repeats` calls, and
each kernel's mean device time (delta, dK/dV, dQ) from a torch.profiler
trace. The first variant is the source as it stands. Prints one JSON line
per variant and shape (with ptxas's registers and spills at d = 128), two
rounds in turn, then the card's name and power limit.
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

VARIANTS = [  # (WARPS, TILE, CHUNK, MIN_BLOCKS); the first is the source's
    (4, 64, 32, 2), (4, 64, 16, 2), (4, 64, 64, 2), (8, 128, 32, 1)]
SHAPES = [(4, 32, 512, 128), (1, 32, 4096, 128)]
RTOL, ATOL = 2.0 ** -7, 2e-5          # bf16 BWD_TOL, atol relative to M
KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel")


def variant_source(source: str, warps: int, tile: int, chunk: int,
                   min_blocks: int) -> str:
    """The tensor-core kernels' constants replaced (namespace tc only)."""
    head, tc = source.split("namespace tc {", 1)
    for name, value in (("WARPS", warps), ("TILE", tile), ("CHUNK", chunk),
                        ("MIN_BLOCKS", min_blocks)):
        tc, n = re.subn(rf"constexpr int {name} = \d+;",
                        f"constexpr int {name} = {value};", tc, count=1)
        if n != 1:
            raise ValueError(f"no constant {name} in the tensor-core kernels")
    return head + "namespace tc {" + tc


def ptxas_lines(report: str) -> dict:
    """ptxas's registers and spills of the bf16 tensor-core kernels at
    d = 128 (NC = 8), by kernel."""
    out, entry = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
            continue
        for name in KERNELS[1:]:
            if entry and f"2tc{len(name)}{name}I13__nv_bfloat16Li8E" in \
                    entry and ("Used" in ln or "spill" in ln):
                out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


def kernel_ms(call, repeats: int) -> dict:
    """Each backward kernel's mean device time over a profiled run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            call()
        torch.cuda.synchronize()
    times = {k: [] for k in KERNELS}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in KERNELS:
            if k in e.name:
                times[k].append(e.time_range.elapsed_us() / 1e3)
    return {k: sum(v) / len(v) if v else None for k, v in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_variants.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = build.BUILD_DIR / "bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "attention.cuh").write_text(
        (build.CSRC / "attention.cuh").read_text())
    source = (build.CSRC / "flash_attn_bwd.cu").read_text()
    nvcc = build._nvcc()
    procs = []
    for i, v in enumerate(VARIANTS):
        src = out_dir / f"bwd_{i}.cu"
        src.write_text(variant_source(source, *v))
        procs.append(subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"bwd_{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = [p.communicate()[0] for p in procs]
    entries = []
    for i, (v, proc, report) in enumerate(zip(VARIANTS, procs, reports)):
        if proc.returncode != 0:
            raise RuntimeError(f"variant {v} failed to build:\n{report}")
        fn = ctypes.CDLL(str(out_dir / f"bwd_{i}.so")).flash_attn_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries.append((v, fn, ptxas_lines(report)))

    inputs = []
    for shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, dout = (torch.randn(shape, device="cuda",
                                     generator=gen).bfloat16()
                         for _ in range(4))
        out, lse = fmod.flash_attention_lse_cuda(q, k, v, causal=True)
        want = fmod.flash_attention_bwd_plain(q, k, v, out, dout, lse)
        inputs.append((shape, (q, k, v, out, dout, lse), want))

    def call(fn, tensors):
        q = tensors[0]
        grads = [torch.empty_like(q) for _ in range(3)]
        delta = torch.empty(q.shape[:3], dtype=torch.float32,
                            device=q.device)
        err = fn(*(t.data_ptr() for t in tensors), delta.data_ptr(),
                 *(g.data_ptr() for g in grads), *q.shape, 1, 0,
                 q.shape[3] ** -0.5, fmod.DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return grads

    for rnd in range(2):
        for shape, tensors, want in inputs:
            for v, fn, props in entries:
                got = call(fn, tensors)
                m = max(float(w.float().abs().max()) for w in want)
                ratio = max(float(((g.float() - w.float()).abs()
                                   / (RTOL * w.float().abs() + ATOL * m))
                                  .max()) for g, w in zip(got, want))
                if not ratio <= 1.0:
                    raise AssertionError(f"variant {v} at {shape}: over the "
                                         f"limit by {ratio}")
                for _ in range(3):
                    call(fn, tensors)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(args.repeats):
                    call(fn, tensors)
                end.record()
                torch.cuda.synchronize()
                print(json.dumps({
                    "round": rnd, "shape": list(shape), "warps": v[0],
                    "tile": v[1], "chunk": v[2], "min_blocks": v[3],
                    "ms": start.elapsed_time(end) / args.repeats,
                    "kernel_ms": kernel_ms(lambda: call(fn, tensors),
                                           args.repeats),
                    "max_err_over_limit": ratio, "ptxas": props}),
                    flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
