"""Model configurations the port serves: `gcn_paper` (the GCN) and the LM
architecture registry, where `--arch <id>` resolves.

Each LM module defines CONFIG (full size, from public literature; served
on the card) and SMOKE (reduced same-family config for CPU tests), the
same values as `repro.configs`. The port's transformer runs every arch
of the registry: the dense GQA archs (Yi-6B, Yi-9B, DeepSeek-7B), Gemma-2
27B (sliding-window layers with ring caches, both softcaps), the MoE
archs Mixtral 8x22B and Kimi K2 (every layer an MOE block; as in the
reference, Mixtral's sliding window is applied to no layer), the
recurrent archs xLSTM-125M (sLSTM and mLSTM blocks) and RecurrentGemma-2B
(RG-LRU blocks and local attention at head dim 256), Qwen2-VL-72B (M-RoPE
and the vision input) and the encoder-decoder SeamlessM4T-medium (a
bidirectional encoder over precomputed audio frames, cross-attention in
every decoder layer).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_ARCH_IDS: List[str] = [
    "xlstm_125m",
    "kimi_k2_1t_a32b",
    "mixtral_8x22b",
    "gemma2_27b",
    "yi_9b",
    "deepseek_7b",
    "yi_6b",
    "seamless_m4t_medium",
    "recurrentgemma_2b",
    "qwen2_vl_72b",
]

ALIAS = {i.replace("_", "-"): i for i in _ARCH_IDS}


def arch_ids() -> List[str]:
    return list(_ARCH_IDS)


def get_config(arch: str, smoke: bool = False):
    arch = ALIAS.get(arch, arch)
    if arch not in _ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


# Input-shape sets shared by all LM archs (assignment spec).
SHAPES: Dict[str, dict] = {
    "train_4k":    dict(kind="train",  seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k":  dict(kind="decode", seq_len=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode", seq_len=524_288, global_batch=1),
}


def shape_applicable(arch: str, shape: str) -> tuple:
    """(runs: bool, reason: str) — the skip rules from the assignment."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch cannot decode at 500k context"
    return True, ""
