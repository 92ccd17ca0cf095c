"""Training launcher: --arch <id> [--smoke] — the port of
`repro.launch.train`, end to end on one device.

Draws the arch's weights from seed 0 on `--device`, feeds `train_loop`
seekable `TokenPipeline` batches under `Supervisor.run`, checkpoints every
quarter of `--steps` into `--ckpt-dir` and, with `--resume`, starts from
the newest checkpoint there. Attention runs the flash kernel forward and
its hand-written backward kernel on the card (`--device cuda`, the
default), their plain versions on the CPU. Every arch of the registry but
the encoder-decoder trains: `--arch recurrentgemma_2b` through the
backward's d = 256 instances, its RG-LRU scan and temporal conv
differentiated as plain PyTorch; `--arch qwen2_vl_72b` with M-RoPE
positions and the vision block's bidirectional prefix over the token
embeddings, and no vision input, as the reference launcher trains it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b \
        [--steps 50] [--compress] [--ckpt-dir DIR [--resume]] [--device cpu]

`--smoke` is on by default, as in the reference (the flag cannot turn it
off): the arch's SMOKE config. As in the reference, a resumed run replays
the checkpointed step's batch on the restored state and numbers its steps
from 0 (ROADMAP.md queue 3, R5), and starts its error feedback from zero.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import init_params
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainLoopConfig, make_optimizer, train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device=device)
    init_opt, _ = make_optimizer(args.optimizer, lr=args.lr)
    opt_state = init_opt(params)

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if args.resume and ck is not None and latest_step(ck.directory) is not None:
        restored, start_step = ck.restore(
            {"params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        print(f"resumed from step {start_step}")

    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch)

    def batches():
        step = start_step
        while True:
            t, lbl = pipe.batch_at(step)
            yield {"tokens": torch.from_numpy(t).to(device),
                   "labels": torch.from_numpy(lbl).to(device)}
            step += 1

    lc = TrainLoopConfig(optimizer=args.optimizer, lr=args.lr,
                         max_steps=args.steps, compress=args.compress,
                         checkpoint_every=max(args.steps // 4, 1))

    sup = Supervisor(SupervisorConfig())

    def body(start):
        nonlocal params, opt_state
        params, opt_state, info = train_loop(
            cfg, lc, params, opt_state, batches(), checkpointer=ck,
            start_step=start)
        for step, loss in info["history"]:
            print(f"step {step:>5d} loss {loss:.4f}")
        print(f"{info['seconds']:.1f}s for {args.steps} steps")
        return args.steps

    sup.run(body, restore=lambda: start_step)


if __name__ == "__main__":
    main()
