#!/usr/bin/env python3
"""Times the two kernels of the decode over a slice of the head dim
(`repro_torch.kernels.decode_attn.decode_scores` and `decode_softmax_v`,
csrc/decode_attn_hd.cu) on one card, each beside its plain version, at
one rank's shapes (b, n_kv, group, S, d'), bf16, every cache full:
Yi-6B decode_32k's slice (8, 4, 8, 32768, 8), Mixtral 8x22B's
(4, 8, 6, 32768, 8) and hints_check's (2, 4, 8, 64, 128).

    python3 scripts/decode_hd_time.py [--root DIR] [--repeats 50]
        [--split-max N] [--blocks-per-sm N]

`--root` takes another checkout (e.g. an unpacked parent commit), whose
`src/` is imported and whose kernels are built, so that two versions are
compared on one card in one call: run it as parent, change, change,
parent. `--split-max` and `--blocks-per-sm` set the wrapper's plan
constants of that name for the run. Each kernel is first held to its plain version (scores within
1e-5 relative and 1e-4 absolute, softmax . V within 2^-7 relative and
4e-6 absolute). Prints one JSON line: per shape and kernel the mean ms per
eager call between two CUDA events around `--repeats` calls, the device
ms (each kernel's mean duration in a profiler trace, by kernel and summed
over the kernels a call launches), the plain version's ms, the bytes each
must move and the bound at 3.35 TB/s, the route where the tree reports
one, and the card's name and power limit. The inputs stay in the card's 50 MB L2 cache
between calls as far as they fit (the reads are warm).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {"yi_6b_decode_32k_slice": (8, 4, 8, 32768, 8),
          "mixtral_decode_32k_slice": (4, 8, 6, 32768, 8),
          "hints_check_shape": (2, 4, 8, 64, 128)}
PEAK_BYTES_PER_S = 3.35e12


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--split-max", type=int, default=None,
                    help="decode_attn.HD_SPLIT_MAX for this run")
    ap.add_argument("--blocks-per-sm", type=int, default=None,
                    help="decode_attn.HD_BLOCKS_PER_SM for this run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("decode_hd_time.py: no CUDA device")
    from repro_torch.kernels import decode_attn as dmod
    for name, value in (("HD_SPLIT_MAX", args.split_max),
                        ("HD_BLOCKS_PER_SM", args.blocks_per_sm)):
        if value is not None:
            setattr(dmod, name, value)

    def event_ms(fn, repeats):
        for _ in range(3):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / repeats

    def device_ms(fn, repeats):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        # A kernel's name without its namespace and template arguments.
        return {name.split("::")[-1].split("<")[0].split("(")[0]:
                sum(v) / len(v) / 1e3 for name, v in by_name.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": args.root, "repeats": args.repeats,
              "split_max": getattr(dmod, "HD_SPLIT_MAX", None),
              "blocks_per_sm": getattr(dmod, "HD_BLOCKS_PER_SM", None),
              "shapes": {}}
    for label, (b, n_kv, group, s_len, d) in SHAPES.items():
        q = torch.randn((b, n_kv, group, d), device="cuda",
                        generator=gen).bfloat16()
        k, v = (torch.randn((b, n_kv, s_len, d), device="cuda",
                            generator=gen).bfloat16() for _ in range(2))
        lens = torch.full((b,), s_len, dtype=torch.int32, device="cuda")
        scale = 1.0 / (16 * d) ** 0.5
        s = dmod.decode_scores_plain(q, k, lens)
        torch.testing.assert_close(dmod.decode_scores(q, k, lens), s,
                                   rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(
            dmod.decode_softmax_v(s, v, lens, scale).float(),
            dmod.decode_softmax_v_plain(s, v, lens, scale).float(),
            rtol=2.0 ** -7, atol=4e-6)
        rows = b * n_kv * s_len
        nbytes = {"decode_scores": 2 * (q.numel() + rows * d) + 4 * s.numel()
                  + 4 * b,
                  "decode_softmax_v": 4 * s.numel() + 2 * (rows * d
                                                           + q.numel())
                  + 4 * b}
        calls = {"decode_scores": (lambda: dmod.decode_scores(q, k, lens),
                                   lambda: dmod.decode_scores_plain(q, k,
                                                                    lens)),
                 "decode_softmax_v": (
                     lambda: dmod.decode_softmax_v(s, v, lens, scale),
                     lambda: dmod.decode_softmax_v_plain(s, v, lens, scale))}
        routes = getattr(dmod, "DECODE_HD_SCORES_ROUTE_LAUNCHES", None)
        before = dict(routes) if routes is not None else None
        dmod.decode_scores(q, k, lens)
        row = {}
        for name, (kernel, plain) in calls.items():
            bound = 1e3 * nbytes[name] / PEAK_BYTES_PER_S
            by_kernel = device_ms(kernel, args.repeats)
            dev = sum(by_kernel.values()) if by_kernel else None
            row[name] = {"ms": event_ms(kernel, args.repeats),
                         "device_ms": dev,
                         "device_ms_by_kernel": by_kernel,
                         "plain_ms": event_ms(plain, 3),
                         "min_bytes": nbytes[name], "bound_ms": bound,
                         "bound_share_device": None if dev is None
                         else bound / dev}
        if before is not None:
            row["decode_scores"]["kernel_route"] = [
                r for r, n in routes.items() if n != before[r]][0]
        result["shapes"][label] = row
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
