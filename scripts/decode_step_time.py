#!/usr/bin/env python3
"""Wall time of one decode step of full-depth bf16 Yi-6B on one card, at
lm_serve's batch (chip_smoke.py: 4 sequences, caches of 160 positions):
`transformer.decode_step` under `torch.inference_mode()`, 32 attention
layers, each one decode-kernel launch.

    python3 scripts/decode_step_time.py [--root DIR] [--rounds 5]

`--root` takes another checkout (e.g. an unpacked parent commit), whose
`src/` is imported and whose kernels are built, so that two versions are
compared on one card in one call: run it as parent, change, change,
parent. Each round starts a fresh state and times 32 steps between two
synchronisations on the host clock (host and card together, as `serve`
makes them), after 8 steps of warm-up. Prints one JSON line: ms per step
by round, their median, the decode launches of a step, and the card's name
and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH, CACHE, WARM, STEPS = 4, 160, 8, 32


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_step_time.py: no CUDA device")
    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.kernels import decode_attn as dmod
    from repro_torch.models import decode_step, init_decode_state, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(CONFIG, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, CONFIG.vocab, (BATCH, WARM + STEPS),
                           device="cuda", generator=gen)
    rounds = []
    with torch.inference_mode():
        for _ in range(args.rounds):
            state = init_decode_state(CONFIG, BATCH, CACHE, device="cuda")
            for t in range(WARM):
                _, state = decode_step(CONFIG, params, tokens[:, t:t + 1],
                                       state)
            torch.cuda.synchronize()
            before = dmod.DECODE_LAUNCHES
            t0 = time.perf_counter()
            for t in range(WARM, WARM + STEPS):
                _, state = decode_step(CONFIG, params, tokens[:, t:t + 1],
                                       state)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / STEPS * 1e3)
            launches = (dmod.DECODE_LAUNCHES - before) / STEPS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "ms_per_step": rounds,
                      "median_ms": statistics.median(rounds),
                      "decode_launches_per_step": launches, "card": card,
                      "torch": torch.__version__}), flush=True)


if __name__ == "__main__":
    main()
