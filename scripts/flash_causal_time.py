#!/usr/bin/env python3
"""Times of the flash kernels at the plain causal calls the dense paths
make (no window, no prefix) on one card: the forward at Yi-6B's prefill
layer (1, 32, 4096, 128) bf16, and the backward at lm_train's microbatch
(4, 32, 512, 128) and at the prefill shape, each without and with
Gemma-2's softcap of 50 (the backward's CAP instances).

    python3 scripts/flash_causal_time.py [--root DIR] [--repeats 20]

`--root` takes another checkout (e.g. an unpacked parent commit), whose
`src/` is imported and whose kernels are built, so that two versions are
compared on one card in one call: run it as parent, change, change,
parent. Prints one JSON line: ms per call between two CUDA events around
`--repeats` calls after a warm-up, the backward's device ms by kernel
(delta_kernel, dkdv_kernel, dq_kernel: the mean of each over a profiler
trace of `--repeats` calls), and the card's name and power limit. The
calls pass only arguments every version since the softcap takes.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_causal_time.py: no CUDA device")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attn as fmod

    def by_kernel(fn) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.repeats):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("<")[0].split("::")[-1]
                times.setdefault(name, []).append(e.time_range.elapsed_us())
        return {n: sum(us) / len(us) / 1e3 for n, us in times.items()}

    def ms(fn) -> float:
        for _ in range(3):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.repeats

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": args.root, "repeats": args.repeats}
    for name, shape in (("prefill", (1, 32, 4096, 128)),
                        ("lm_train", (4, 32, 512, 128))):
        q, k, v, dout = (torch.randn(shape, device="cuda",
                                     generator=gen).bfloat16()
                         for _ in range(4))
        with torch.no_grad():
            row = {"forward_ms": ms(lambda: fmod.flash_attention_cuda(
                q, k, v, causal=True))}
            for cap in (None, 50.0):
                out, lse = fmod.flash_attention_lse_cuda(q, k, v, causal=True,
                                                         softcap=cap)
                key = "backward" if cap is None else "backward_cap50"

                def bwd():
                    fmod.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                  True, 0, cap)
                row[f"{key}_ms"] = ms(bwd)
                row[f"{key}_device_ms_by_kernel"] = by_kernel(bwd)
        result[name] = {"shape": list(shape), "dtype": "bfloat16", **row}
    result["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
