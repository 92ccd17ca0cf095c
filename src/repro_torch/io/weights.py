"""Out-of-core weight streaming: the AIRES engine applied to parameters.

The paper's dual-way schedule generalizes beyond SpGEMM operands: for a
384-expert MoE whose expert bank exceeds device memory, expert weight
bricks play the role of CSR-A segments (aligned, complete-expert blocks:
the RoBW invariant "never split a row" becomes "never split an expert"),
while the router and attention weights stay resident like CSC-B. Phase II
double-buffers expert uploads against the previous block's compute.

The port of `repro.io.weights`: the same host-side registry and block
plan, streamed through `io.streamer.DoubleBufferedStreamer`. On a CUDA
device each block goes from pinned host memory to the card on the
streamer's copy stream (`non_blocking=True`), the consumer's stream
waiting on its event; a bank tensor that is not pinned is staged through
a pinned copy of the block alone. On the CPU the same loop yields views of
the bank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.io.streamer import DoubleBufferedStreamer, StreamStats


def _host_tensor(a: Any) -> torch.Tensor:
    """A CPU tensor of `a` (a CPU tensor as it is; numpy shared without a
    copy, a bfloat16 array from ml_dtypes by its bits)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"expert banks live in host memory, got a "
                             f"tensor on {a.device}")
        return a
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class ExpertBank:
    """Host-resident expert parameters for one layer: a dict of (E, ...)
    CPU tensors (numpy arrays are taken too, and held as tensors sharing
    their memory), e.g. w_gate (E, d, f), w_up, w_down."""

    layer: int
    arrays: Mapping[str, Any]

    def __post_init__(self):
        self.arrays = {k: _host_tensor(a) for k, a in self.arrays.items()}
        sizes = {a.shape[0] for a in self.arrays.values()}
        if len(sizes) != 1:
            raise ValueError(f"every array needs the same expert count, got "
                             f"{sorted(sizes)}")

    @property
    def n_experts(self) -> int:
        return next(iter(self.arrays.values())).shape[0]

    def expert_bytes(self) -> int:
        return sum(a[0].numel() * a.element_size()
                   for a in self.arrays.values())

    def slice_experts(self, ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.long)
        return {k: a[idx] for k, a in self.arrays.items()}


class StreamedWeightProvider:
    """RoBW-for-experts: group experts into aligned blocks that fit the
    per-step device budget, stream them double-buffered across layers.

    `block_size` = max(align, (budget // expert_bytes // align) · align)
    experts, as the reference plans it; `stats` sums the `StreamStats` of
    every `stream_layer` (uploaded bytes are each block's bytes)."""

    def __init__(self, banks: List[ExpertBank], hbm_budget_bytes: int,
                 align: int = 8, depth: int = 2,
                 deadline_s: Optional[float] = None,
                 device: "str | torch.device" = "cuda"):
        self.banks = banks
        self.align = align
        per_expert = banks[0].expert_bytes() if banks else 1
        per_block = max(1, hbm_budget_bytes // max(per_expert, 1))
        # Complete, aligned expert blocks (the RoBW invariant).
        self.block_size = max(align, (per_block // align) * align)
        self.depth = depth
        self.deadline_s = deadline_s
        self.device = torch.device(device)
        self.stats = StreamStats()

    def blocks_for(self, bank: ExpertBank) -> List[Tuple[int, int]]:
        e = bank.n_experts
        return [(s, min(s + self.block_size, e))
                for s in range(0, e, self.block_size)]

    def _upload(self, payload):
        (s, e), arrays = payload
        if self.device.type == "cpu":
            return (s, e), dict(arrays)
        dev = {}
        for k, a in arrays.items():
            host = a if a.is_pinned() else a.pin_memory()
            dev[k] = host.to(self.device, non_blocking=True)
        return (s, e), dev

    def stream_layer(self, bank: ExpertBank) -> Iterator[
            Tuple[Tuple[int, int], Dict[str, torch.Tensor]]]:
        """Yield ((first, end), {name: (end - first, ...) tensor on the
        device}) for each block of one layer, `depth` blocks in flight;
        each block is ready on the current stream when it is yielded."""

        def produce():
            for (s, e) in self.blocks_for(bank):
                yield (s, e), {k: a[s:e] for k, a in bank.arrays.items()}

        def nbytes(payload):
            return sum(a.numel() * a.element_size()
                       for a in payload[1].values())

        streamer = DoubleBufferedStreamer(
            self._upload, lambda dev_payload, i: dev_payload,
            depth=self.depth, deadline_s=self.deadline_s,
            payload_nbytes=nbytes, device=self.device)
        streamer.stats = self.stats
        yield from streamer.run(produce())
