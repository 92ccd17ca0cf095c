"""Out-of-core MoE expert streaming in the PyTorch port: the AIRES engine
applied to weights.

The counterpart of `examples/ooc_expert_streaming.py`, with the same bank
(four layers of 64 experts, d 32, f 16, from numpy seed 0), budget (12
experts' bytes), alignment (4) and depth (2). The RoBW invariant ("never
split a row") becomes "never split an expert": expert blocks stream
host->device double-buffered while the router and attention weights stay
resident. On the card the bank is pinned once and every block goes up on
the streamer's copy stream; each block is checked against the host bank
value for value, and the uploaded bytes against the bank's.

Run:  PYTHONPATH=src python examples/ooc_expert_streaming_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.io import ExpertBank, StreamedWeightProvider


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    E, D, F = 64, 32, 16
    banks = [ExpertBank(layer=layer, arrays={
        "w_gate": rng.standard_normal((E, D, F)).astype(np.float32),
        "w_up": rng.standard_normal((E, D, F)).astype(np.float32),
        "w_down": rng.standard_normal((E, F, D)).astype(np.float32),
    }) for layer in range(4)]
    if dev.type == "cuda":               # pinned once, uploaded per block
        for bank in banks:
            bank.arrays = {k: a.pin_memory() for k, a in bank.arrays.items()}

    per_expert = banks[0].expert_bytes()
    provider = StreamedWeightProvider(banks, hbm_budget_bytes=per_expert * 12,
                                      align=4, depth=2, device=dev)
    total_blocks = 0
    for bank in banks:
        for (s, e), arrays in provider.stream_layer(bank):
            # a real layer would run the expert matmuls for experts [s, e)
            assert arrays["w_gate"].shape[0] == e - s
            assert arrays["w_gate"].device.type == dev.type
            for name, a in arrays.items():
                assert torch.equal(a.cpu(), bank.arrays[name][s:e]), name
            total_blocks += 1
    bank_bytes = sum(b.expert_bytes() * b.n_experts for b in banks)
    print(f"streamed {total_blocks} aligned expert blocks across "
          f"{len(banks)} layers (block_size={provider.block_size} experts) "
          f"on {dev}, {provider.stats.uploaded_bytes} B uploaded")
    assert provider.block_size % 4 == 0
    assert provider.stats.uploaded_bytes == bank_bytes
    print("OK")


if __name__ == "__main__":
    main()
