"""The decoder stack of `repro.models.transformer`, dense GQA subset: every
layer an `ATTN` block (RMSNorm, causal GQA self-attention with RoPE,
RMSNorm, SwiGLU MLP), as in Yi-6B, Yi-9B and DeepSeek-7B.

`forward` (training / prefill) attends through the flash kernel;
`decode_step` (serving) attends one new token per sequence against a KV
cache through the GQA flash-decode kernel. Params are a dict of tensors
shaped like the reference's pytree (`params_from_numpy` carries one over).

JAX idioms with no counterpart here: `cfg.remat` (`jax.checkpoint`)
means nothing without a backward and is not read; the sharding hints
(`mesh_axes`) have no argument. Other block kinds (sliding-window ring
caches, MoE, recurrent blocks), M-RoPE and the vision, audio and encoder
inputs raise `NotImplementedError` (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig, BlockKind

_ITEM = "ROADMAP.md queue 1 item 8"


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg: ArchConfig) -> None:
    unported = [name for name, on in (
        ("an encoder-decoder", cfg.is_enc_dec),
        ("a vision frontend", cfg.n_vision_tokens > 0),
        ("an audio frontend", cfg.audio_frames > 0),
        ("M-RoPE", cfg.mrope_sections is not None),
        ("an attention softcap", cfg.attn_softcap is not None),
    ) if on]
    kinds = sorted({k.value for k in cfg.blocks()} - {BlockKind.ATTN.value})
    if kinds:
        unported.append(f"block kinds {kinds}")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported to repro_torch "
            f"yet ({_ITEM}); the port runs dense ATTN stacks")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _param_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """The pytree of (shape, init std) leaves; std None means zeros."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5

    def layer() -> Dict[str, Any]:
        p: Dict[str, Any] = {
            "ln1": ((d,), None),
            "attn": {"wq": ((d, hq * hd), s), "wk": ((d, hkv * hd), s),
                     "wv": ((d, hkv * hd), s),
                     "wo": ((hq * hd, d), (hq * hd) ** -0.5)},
            "ln2": ((d,), None),
        }
        if cfg.d_ff:
            f = cfg.d_ff
            p["mlp"] = {"w_gate": ((d, f), s), "w_up": ((d, f), s),
                        "w_down": ((f, d), f ** -0.5)}
        return p

    spec: Dict[str, Any] = {"embed": ((cfg.vocab, d), s),
                            "final_norm": ((d,), None)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, cfg.vocab), s)
    spec["layers"] = [layer() for _ in range(cfg.n_layers)]
    return spec


def _map_spec(spec: Any, tree: Any, fn, path: str = "") -> Any:
    """fn(path, (shape, std), leaf) over the spec's leaves, with the
    matching leaf of `tree` (or None)."""
    if isinstance(spec, list):
        if tree is not None and len(tree) != len(spec):
            raise ValueError(f"{path}: {len(tree)} entries, expected "
                             f"{len(spec)}")
        return [_map_spec(s, None if tree is None else tree[i], fn,
                          f"{path}[{i}]") for i, s in enumerate(spec)]
    if isinstance(spec, dict):
        if tree is not None and set(tree) != set(spec):
            raise ValueError(f"{path}: keys {sorted(tree)}, expected "
                             f"{sorted(spec)}")
        return {k: _map_spec(s, None if tree is None else tree[k], fn,
                             f"{path}/{k}") for k, s in spec.items()}
    return fn(path, spec, tree)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: "str | torch.device" = "cuda") -> Dict[str, Any]:
    """Random weights N(0, 1/fan_in) and zero norm scales, as the reference
    draws them, made on `device` in `cfg.dtype` one tensor at a time from
    `generator` (a generator on that device)."""
    _check_supported(cfg)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"params go to {device}")
    dt = _dtype(cfg)

    def draw(path, leaf, _):
        shape, std = leaf
        if std is None:
            return torch.zeros(shape, dtype=dt, device=device)
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(std).to(dt)

    return _map_spec(_param_spec(cfg), None, draw)


def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                      device: "str | torch.device") -> Dict[str, Any]:
    """Carry the reference's param pytree (numpy leaves, e.g. through
    `jax.tree_util.tree_map(np.asarray, params)`) onto `device`, values and
    dtypes unchanged; raises where its structure or shapes differ from
    `cfg`'s."""
    _check_supported(cfg)

    def carry(path, leaf, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != leaf[0]:
            raise ValueError(f"{path}: shape {arr.shape}, expected {leaf[0]}")
        if arr.dtype.name == "bfloat16":     # ml_dtypes, as JAX gives it
            t = torch.from_numpy(arr.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(device)

    return _map_spec(_param_spec(cfg), tree, carry)


def param_count(params: Any) -> int:
    if isinstance(params, Mapping):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()


# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------

def _layer_apply(cfg: ArchConfig, kind: BlockKind, p: Dict[str, Any],
                 x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One ATTN block (no MoE, so no aux loss)."""
    if kind != BlockKind.ATTN:
        raise NotImplementedError(f"{kind.value} blocks are not ported yet "
                                  f"({_ITEM})")
    h = L.rms_norm(x, p["ln1"])
    attn_out, _ = L.attention(cfg, p["attn"], h, positions)
    x = x + attn_out
    if "mlp" in p:
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    return x


def _build_positions(cfg: ArchConfig, b: int, s: int,
                     device: "str | torch.device") -> torch.Tensor:
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"M-RoPE positions are not ported yet "
                                  f"({_ITEM})")
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(
        b, s)


def _logits(cfg: ArchConfig, params: Dict[str, Any],
            x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.matmul(x, head)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None,
            audio_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int on the params' device → (logits (B, S, V), aux
    loss, 0 for dense stacks). One flash-attention launch per layer on the
    card."""
    _check_supported(cfg)
    if vision_embeds is not None or audio_embeds is not None:
        raise NotImplementedError(f"vision and audio inputs are not ported "
                                  f"yet ({_ITEM})")
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = _build_positions(cfg, b, s, x.device)
    for kind, p in zip(cfg.blocks(), params["layers"]):
        x = _layer_apply(cfg, kind, p, x, positions)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def lm_loss(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
            labels: torch.Tensor, vision_embeds=None,
            audio_embeds=None) -> torch.Tensor:
    """Mean next-token NLL (+ 0.01 × aux), forward only: the kernels have
    no backward yet."""
    logits, aux = forward(cfg, params, tokens, vision_embeds, audio_embeds)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold) + 0.01 * aux


# --------------------------------------------------------------------------
# Decode (serve_step): one new token against the KV cache
# --------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype: Optional[torch.dtype] = None, *,
                      device: "str | torch.device" = "cuda"
                      ) -> Dict[str, Any]:
    """Per-layer KV caches (B, n_kv_heads, max_len, hd) on `device`, in
    `dtype` (`cfg.dtype` when None, as in the reference), and the position
    of the next token, a Python int."""
    _check_supported(cfg)
    dt = dtype or _dtype(cfg)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    layers: List[Dict[str, torch.Tensor]] = [
        {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
        for _ in cfg.blocks()]
    return {"pos": 0, "layers": layers}


def _decode_attn(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                 h: torch.Tensor, state: Dict[str, torch.Tensor], pos: int,
                 posb: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """One-token attention against the cache: writes this token's K and V
    at `pos` in place, then attends over positions 0..pos."""
    b = h.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ p["wq"]).reshape(b, 1, hq, hd).transpose(1, 2)
    k_new = (h @ p["wk"]).reshape(b, 1, hkv, hd).transpose(1, 2)
    v_new = (h @ p["wv"]).reshape(b, 1, hkv, hd).transpose(1, 2)
    q = L.apply_rope(q, posb, cfg.rope_theta)
    k_new = L.apply_rope(k_new, posb, cfg.rope_theta)
    state["k"][:, :, pos] = k_new[:, :, 0].to(state["k"].dtype)
    state["v"][:, :, pos] = v_new[:, :, 0].to(state["v"].dtype)
    out = ops.decode_attention(q[:, :, 0], state["k"], state["v"], lens)
    return out.reshape(b, 1, hq * hd).to(h.dtype) @ p["wo"]


def decode_step(cfg: ArchConfig, params: Dict[str, Any], token: torch.Tensor,
                state: Dict[str, Any], enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token (B, 1) int → (logits (B, 1, V), new state).

    The caches are updated in place (the reference returns new arrays), so
    the new state holds the same cache tensors; `pos` advances by one. One
    decode-attention launch per layer on the card; `lens` (pos + 1 for
    every sequence) is filled on the device, with no host sync.
    """
    _check_supported(cfg)
    if enc_out is not None:
        raise NotImplementedError(f"encoder outputs are not ported yet "
                                  f"({_ITEM})")
    b = token.shape[0]
    pos = state["pos"]
    max_len = state["layers"][0]["k"].shape[2]
    if not 0 <= pos < max_len:
        raise ValueError(f"position {pos} is outside the cache of {max_len}")
    x = params["embed"][token]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    lens = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    for li, p in enumerate(params["layers"]):
        h = L.rms_norm(x, p["ln1"])
        x = x + _decode_attn(cfg, p["attn"], h, state["layers"][li], pos,
                             posb, lens)
        if "mlp" in p:
            x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]))
    return _logits(cfg, params, x), {"pos": pos + 1,
                                     "layers": state["layers"]}
