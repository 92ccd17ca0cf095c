#!/usr/bin/env python3
"""Per-call time of the GQA flash-decode wrapper
(`repro_torch.kernels.decode_attn.decode_attention_cuda`) on one card, at
the shapes of one decode step's layer: lm_serve's (Yi-6B, q (4, 4, 8, 128),
caches (4, 4, 161, 128) bf16) and gemma_serve's (Gemma-2 27B, q
(4, 16, 2, 128), caches (4, 16, 161, 128) bf16), every cache full.

    python3 scripts/decode_wrapper_time.py [--root DIR] [--repeats 2000]

`--root` takes another checkout (e.g. an unpacked parent commit), whose
`src/` is imported and whose kernels are built, so that two versions are
compared on one card in one call: run it as parent, change, change,
parent. Prints one JSON line: for each shape the mean ms per eager call
between two CUDA events around `--repeats` calls (host and card together,
as `decode_step` makes them), the kernels' device ms from a profiler
trace, the host µs of the wrapper's parts as it made them before it
cached the plan and took one scratch allocation (its operand checks, the
SM count and split plan, the output and three scratch allocations,
entering the device and reading the stream, the ctypes launch of both
kernels on buffers allocated once), and the card's name and power limit.
No softcap is passed, so the same call runs on a tree that has none.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def host_us(fn, repeats: int) -> float:
    """Mean host µs per call of `fn` (which launches nothing, or whose
    launches the card keeps up with), after a warm-up."""
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--repeats", type=int, default=2000)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("decode_wrapper_time.py: no CUDA device")
    from repro_torch.kernels import decode_attn as dmod

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": args.root, "repeats": args.repeats}
    for name, (b, n_kv, group, s_len) in (("lm_serve", (4, 4, 8, 161)),
                                          ("gemma_serve", (4, 16, 2, 161))):
        q = torch.randn((b, n_kv, group, 128), device="cuda",
                        generator=gen).bfloat16()
        k, v = (torch.randn((b, n_kv, s_len, 128), device="cuda",
                            generator=gen).bfloat16() for _ in range(2))
        lens = torch.full((b,), s_len, dtype=torch.int32, device="cuda")

        def call():
            return dmod.decode_attention_cuda(q, k, v, lens)

        for _ in range(50):
            call()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.repeats):
            call()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        d = q.shape[3]
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        chunk, n_splits = dmod.split_plan(b, n_kv, s_len, n_sm)
        part = (b, n_kv, n_splits, group)
        bufs = [torch.empty(part, device="cuda"),
                torch.empty(part, device="cuda"),
                torch.empty((*part, d), device="cuda"), torch.empty_like(q)]
        fn = dmod._launch_fn()
        stream = torch.cuda.current_stream().cuda_stream
        extra = (0.0,) if len(fn.argtypes) == 19 else ()    # a softcap
        launch_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       lens.data_ptr(), *(t.data_ptr() for t in bufs), b,
                       n_kv, group, s_len, d, chunk, n_splits, d ** -0.5,
                       *extra, dmod.DTYPE_CODES[q.dtype], stream)

        def device_and_stream():
            with torch.cuda.device(q.device):
                return torch.cuda.current_stream(q.device).cuda_stream

        parts = {
            "checks": host_us(lambda: (dmod._check(q, k, v, lens),
                                       dmod.no_grad_guard("d", q, k, v)),
                              args.repeats),
            "sm_count_and_plan": host_us(lambda: dmod.split_plan(
                b, n_kv, s_len, torch.cuda.get_device_properties(
                    q.device).multi_processor_count), args.repeats),
            "four_allocations": host_us(lambda: [
                torch.empty(part, dtype=torch.float32, device=q.device),
                torch.empty(part, dtype=torch.float32, device=q.device),
                torch.empty((*part, d), dtype=torch.float32,
                            device=q.device), torch.empty_like(q)],
                args.repeats),
            "device_and_stream": host_us(device_and_stream, args.repeats)}
        # 200 calls: fewer launches than the card queues, so the host is
        # not held back by the kernels it enqueued.
        torch.cuda.synchronize()
        parts["ctypes_launch"] = host_us(lambda: fn(*launch_args), 200)
        torch.cuda.synchronize()
        parts["whole_call"] = host_us(call, 200)
        torch.cuda.synchronize()
        result[name] = {
            "ms_per_call": start.elapsed_time(end) / args.repeats,
            "device_ms_per_call":
                sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / 100,
            "host_us": parts}
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
