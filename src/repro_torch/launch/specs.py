"""input_specs(): meta-tensor stand-ins for every model input, as
`repro.launch.specs` gives `ShapeDtypeStruct`s: the same keys and shapes,
torch dtypes (int32 ids, `cfg.dtype` embeddings), and no storage.
Modality frontends are stubs: audio and vision cells receive precomputed
frame and patch embeddings here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.config import ArchConfig


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """shape: {"kind": train|prefill|decode, "seq_len": int,
    "global_batch": int}."""
    b = shape["global_batch"]
    s = shape["seq_len"]
    kind = shape["kind"]
    act_dt = getattr(torch, cfg.dtype)
    ids = torch.int32

    def modalities(specs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if cfg.n_vision_tokens:
            specs["vision_embeds"] = _meta(
                (b, cfg.n_vision_tokens, cfg.d_model), act_dt)
        if cfg.is_enc_dec:
            specs["audio_embeds"] = _meta(
                (b, cfg.audio_frames, cfg.d_model), act_dt)
        return specs

    if kind == "train":
        return modalities({"tokens": _meta((b, s), ids),
                           "labels": _meta((b, s), ids)})
    if kind == "prefill":
        return modalities({"tokens": _meta((b, s), ids)})
    if kind == "decode":
        # One new token against a KV/recurrent state of length seq_len.
        specs = {"token": _meta((b, 1), ids)}
        if cfg.is_enc_dec:
            specs["enc_out"] = _meta((b, cfg.audio_frames, cfg.d_model),
                                     act_dt)
        return specs
    raise ValueError(f"unknown shape kind {kind!r}")
