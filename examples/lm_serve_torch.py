"""Serve a small LM of the PyTorch port with batched requests through the
decode path.

Uses the recurrentgemma smoke config (hybrid RG-LRU + local attention),
as `examples/lm_serve.py` does, through the same `serve`, with the same
batch, prompt length, step count and check. On the card every decode step
runs the GQA flash-decode kernel in its local layer.

Run:  PYTHONPATH=src python examples/lm_serve_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.models import init_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("recurrentgemma_2b", smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 6),
                                                dtype=np.int32)
    tokens = serve(cfg, params, prompts, steps=10)
    print(f"served batch of 4 requests, 10 tokens each, on {dev}:")
    print(tokens)
    if tokens.shape != (4, 10):
        raise AssertionError(f"tokens of shape {tokens.shape}, want (4, 10)")
    print("OK")


if __name__ == "__main__":
    main()
