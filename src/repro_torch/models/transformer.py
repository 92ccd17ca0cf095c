"""The stacks of `repro.models.transformer`: a decoder whose every layer is
an `ATTN` block (RMSNorm, causal GQA
self-attention with RoPE, RMSNorm, SwiGLU MLP), as in Yi-6B, Yi-9B and
DeepSeek-7B, or with M-RoPE and the vision input, as in Qwen2-VL-72B; a
`LOCAL_ATTN` block, the same within a sliding window, as
Gemma-2 27B alternates them; a `MOE` block, causal attention and then the
top-k MoE feed-forward (`layers.moe_ffn`), as in Mixtral 8x22B and Kimi
K2; with the attention and final-logit softcaps where the config sets
them; or a recurrent block (`models.recurrent`): `SLSTM` and `MLSTM`, as
xLSTM-125M mixes them, and `RGLRU` (a GeLU gate times the temporal conv
and RG-LRU branch), as RecurrentGemma-2B alternates two with a local
attention layer. A recurrent block has an MLP only where `cfg.d_ff` is set.

The encoder-decoder (SeamlessM4T-medium, `cfg.encoder_layers` > 0):
`encode` projects precomputed audio frames (B, frames, d_model) by
`audio_proj` (the reference's stub of a speech frontend) and runs the
encoder's `ATTN` layers bidirectionally (self-attention through
`cross_kv` against itself: no RoPE, no mask), then `enc_norm`; every
decoder layer carries `ln_x` and `xattn` and, in `forward` and
`decode_step`, attends after its self-attention over the encoder output
(cross-attention, K and V projected from `enc_out` in every layer on every
call, as the reference does). A config without an encoder ignores
`audio_embeds`, as the reference's does.

As in the reference, only `LOCAL_ATTN` layers take `sliding_window`: an
MoE config's layers are all `MOE` blocks, which attend over every earlier
position and decode into full caches, so Mixtral's window of 4096 is not
applied.

`forward` (training / prefill) attends through the flash kernel and sums
the MoE layers' aux losses; `lm_loss` is differentiable through it
(`kernels.flash_attn.FlashAttention`: the forward kernel and its
hand-written backward, the softcap included); `decode_step` (serving)
attends one new token per sequence against a KV cache, a ring of
`sliding_window` slots on `LOCAL_ATTN` layers, through the GQA
flash-decode kernel, and steps each recurrent layer's O(1) state. Params
are a dict of tensors shaped like the reference's pytree
(`params_from_numpy` carries one over).

Qwen2-VL (`cfg.mrope_sections`, `cfg.n_vision_tokens` = nv): `forward`
puts `vision_embeds` (B, nv, d_model), projected by `vision_proj` (the
reference's stub of a vision tower), in place of the first nv token
embeddings, and attends with M-RoPE positions from `_build_positions`
under the reference's mask, in which the nv vision positions see each
other in both directions. As in the reference, `decode_step` rotates by
plain RoPE at the index `pos` under a causal cache mask, so its logits are
not the forward's (ROADMAP.md queue 3, R6).

`cfg.remat`, `jax.checkpoint` per layer in the reference, is
`torch.utils.checkpoint` per layer here, taken only while autograd records
(never under `torch.no_grad()` or `torch.inference_mode()`): the backward
recomputes each layer's forward, flash launch included.

Sharding hints: with `mesh_axes` (`MESH_AXES_SINGLE` or `MESH_AXES_MULTI`)
and DTensor params on a `DeviceMesh`, `_shard` redistributes the
activations at the reference's points (the embeddings, each layer's output,
the encoder's input and the logits), where the reference places a
`with_sharding_constraint`; `moe_ffn` takes its two. Without `mesh_axes`
nothing is redistributed. With `mesh_axes` and plain tensors `_shard`
raises RuntimeError, as the reference's constraint raises outside a mesh.
`decode_step` takes `mesh_axes` and, as the reference's, reads no hint.
With DTensor caches (placed by `launch.sharding.state_pspecs`) each rank
writes the token's K and V into its own shard and attends over it
(`_decode_attn_local`), so that no cache moves.
"""
from __future__ import annotations

import functools
import sys
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.config import ArchConfig, BlockKind

_ATTENTION = (BlockKind.ATTN, BlockKind.LOCAL_ATTN, BlockKind.MOE)
# The param key of each recurrent block kind, as the reference names it.
_RECURRENT_KEY = {BlockKind.MLSTM: "mlstm", BlockKind.SLSTM: "slstm",
                  BlockKind.RGLRU: "rec"}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _shard(x: torch.Tensor, mesh_axes, spec) -> torch.Tensor:
    """mesh_axes: None (no hints) or {"data": axes, "model": axis}. spec
    entries are "data"/"model"/None and resolve per mesh, so the same model
    code runs on single-pod (data, model) and multi-pod (pod, data, model)
    meshes, as the reference's `_shard` resolves them. x, a DTensor, is
    redistributed to the placements the resolved spec means on its mesh
    (`launch.sharding.placements`); a plain tensor raises RuntimeError, as
    `with_sharding_constraint` raises outside a mesh, and so does an axis
    the mesh lacks."""
    if mesh_axes is None:
        return x
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.sharding import P, placements
    spec = P(*(mesh_axes.get(a, None) if isinstance(a, str) else a
               for a in spec))
    if not isinstance(x, DTensor):
        raise RuntimeError(
            f"a sharding hint {spec} needs a DTensor on a DeviceMesh, got a "
            f"plain tensor: with mesh_axes, give the params as DTensors "
            f"(launch.sharding.tree_placements), as the reference's "
            f"with_sharding_constraint needs a mesh in context")
    mesh = x.device_mesh
    names = {n for e in spec for n in (e if isinstance(e, tuple) else (e,))
             if n is not None}
    if not names <= set(mesh.mesh_dim_names):
        raise ValueError(f"the hint {spec} names axes "
                         f"{sorted(names - set(mesh.mesh_dim_names))} that "
                         f"the mesh {mesh.mesh_dim_names} lacks")
    return x.redistribute(mesh, placements(spec, mesh))


MESH_AXES_SINGLE = {"data": ("data",), "model": "model"}
MESH_AXES_MULTI = {"data": ("pod", "data"), "model": "model"}


def register_dtensor_rules() -> None:
    """The DTensor sharding rules of the operators the model calls: the
    attention kernels' (`ops.register_dtensor_rules`) and the sLSTM loop's
    and `F.logsigmoid`'s (`recurrent.register_sharding`), each once. The
    callers that turn DTensor on call it: `on_mesh` and the dry run."""
    ops.register_dtensor_rules()
    R.register_sharding()


def on_mesh(fn):
    """Run `fn` with the plain tensors the model makes beside DTensor
    params (positions, RoPE frequencies, the MoE's slot indices) taken as
    replicated on their mesh: DTensor's `implicit_replication`, the
    counterpart of the reference's mesh in context, with the operators'
    sharding rules registered (`register_dtensor_rules`). A process that
    has not imported DTensor holds no DTensor, and its calls run as they
    are. Inside a
    trace (`torch.compile`, the dry run) the context cannot be entered, so
    the tracer enters it around the call."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if torch.compiler.is_compiling() or \
                "torch.distributed.tensor" not in sys.modules:
            return fn(*args, **kwargs)
        from torch.distributed.tensor.experimental import implicit_replication
        register_dtensor_rules()
        with implicit_replication():
            return fn(*args, **kwargs)
    return wrapped


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

class _Fill(float):
    """A spec leaf's constant value (the RG-LRU's lambda), not a std."""


def _param_spec(cfg: ArchConfig) -> Dict[str, Any]:
    """The pytree of (shape, init) leaves, init the normal's std, None for
    zeros or a `_Fill` constant; the reference's `_init_*` shapes."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5

    def mlp() -> Dict[str, Any]:
        f = cfg.d_ff
        return {"w_gate": ((d, f), s), "w_up": ((d, f), s),
                "w_down": ((f, d), f ** -0.5)}

    def recurrent(kind: BlockKind) -> Dict[str, Any]:
        if kind == BlockKind.MLSTM:
            return {"wq": ((d, d), s), "wk": ((d, d), s), "wv": ((d, d), s),
                    "wi": ((d, hq), s), "wf": ((d, hq), s),
                    "gn": ((d,), None), "wo": ((d, d), s)}
        if kind == BlockKind.SLSTM:
            return {**{n: ((d, d), s) for n in ("wz", "wi_g", "wf_g",
                                                "wo_g")},
                    **{n: ((d, d), s * 0.5) for n in ("rz", "ri", "rf",
                                                      "ro")},
                    "wo": ((d, d), s)}
        w = cfg.lru_width or d
        return {"w_branch_gate": ((d, w), s), "w_branch_lin": ((d, w), s),
                "conv_w": ((cfg.conv_width, w), 0.1),
                "conv_b": ((w,), None),
                "w_rec_gate": ((w, w), w ** -0.5),
                "w_in_gate": ((w, w), w ** -0.5),
                "lambda": ((w,), _Fill(0.6)),
                "w_out": ((w, d), w ** -0.5)}

    def attn() -> Dict[str, Any]:
        return {"wq": ((d, hq * hd), s), "wk": ((d, hkv * hd), s),
                "wv": ((d, hkv * hd), s),
                "wo": ((hq * hd, d), (hq * hd) ** -0.5)}

    def layer(kind: BlockKind, cross: bool) -> Dict[str, Any]:
        p: Dict[str, Any] = {"ln1": ((d,), None)}
        if kind not in _ATTENTION:
            p[_RECURRENT_KEY[kind]] = recurrent(kind)
            if cfg.d_ff:
                p["ln2"] = ((d,), None)
                p["mlp"] = mlp()
        else:
            p["attn"] = attn()
            p["ln2"] = ((d,), None)
            if kind == BlockKind.MOE:            # the reference's _init_moe
                e, f = cfg.n_experts, cfg.expert_d_ff or cfg.d_ff
                p["moe"] = {"w_router": ((d, e), s),
                            "w_gate": ((e, d, f), s),
                            "w_up": ((e, d, f), s),
                            "w_down": ((e, f, d), f ** -0.5)}
            elif cfg.d_ff:
                p["mlp"] = mlp()
        if cross:                 # every decoder layer of an encoder-decoder
            p["ln_x"] = ((d,), None)
            p["xattn"] = attn()
        return p

    spec: Dict[str, Any] = {"embed": ((cfg.vocab, d), s),
                            "final_norm": ((d,), None)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((d, cfg.vocab), s)
    spec["layers"] = [layer(kind, cfg.is_enc_dec) for kind in cfg.blocks()]
    if cfg.is_enc_dec:
        spec["enc_layers"] = [layer(BlockKind.ATTN, False)
                              for _ in range(cfg.encoder_layers)]
        spec["enc_norm"] = ((d,), None)
    if cfg.n_vision_tokens:         # the stub projection of patch embeddings
        spec["vision_proj"] = ((d, d), s)
    if cfg.audio_frames:            # ... and of audio frame embeddings
        spec["audio_proj"] = ((d, d), s)
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


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator],
                device: "str | torch.device" = "cuda") -> Dict[str, Any]:
    """Random weights N(0, std²), zero norm scales and the RG-LRU's
    constant lambda, as the reference draws them, made on `device` in
    `cfg.dtype` one tensor at a time from `generator` (a generator on that
    device). On the meta device, with `generator` None, nothing is drawn:
    the shapes and dtypes alone, as `jax.eval_shape` gives them."""
    device = torch.device(device)
    dt = _dtype(cfg)
    if device.type == "meta":
        if generator is not None:
            raise ValueError("the meta device draws nothing: pass "
                             "generator=None")
        return _map_spec(_param_spec(cfg), None, lambda path, leaf, _:
                         torch.empty(leaf[0], dtype=dt, device=device))
    if generator is None or generator.device.type != device.type:
        raise ValueError(f"the generator lies on "
                         f"{getattr(generator, 'device', None)}, the params "
                         f"go to {device}")

    def draw(path, leaf, _):
        shape, std = leaf
        if std is None:
            return torch.zeros(shape, dtype=dt, device=device)
        if isinstance(std, _Fill):
            return torch.full(shape, float(std), dtype=dt, device=device)
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(std).to(dt)

    return _map_spec(_param_spec(cfg), None, draw)


def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                      device: "str | torch.device") -> Dict[str, Any]:
    """Carry the reference's param pytree (numpy leaves, e.g. through
    `jax.tree_util.tree_map(np.asarray, params)`) onto `device`, values and
    dtypes unchanged; raises where its structure or shapes differ from
    `cfg`'s."""

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

def _ffn(cfg: ArchConfig, kind: BlockKind, p: Dict[str, Any],
         h2: torch.Tensor, mesh_axes=None
         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The block's feed-forward on the normed residual: (out or None, aux
    loss f32; 0 but for MoE, which takes the hints)."""
    if kind == BlockKind.MOE:
        return L.moe_ffn(cfg, p["moe"], h2, mesh_axes)
    zero = torch.zeros((), device=h2.device)
    if "mlp" in p:
        return L.mlp(p["mlp"], h2), zero
    return None, zero


def _recurrent_apply(cfg: ArchConfig, kind: BlockKind, p: Dict[str, Any],
                     h: torch.Tensor) -> torch.Tensor:
    """A recurrent block's mixer on the normed residual h (B, S, D)."""
    if kind == BlockKind.MLSTM:
        return R.mlstm_train(p["mlstm"], h, cfg.n_heads)
    if kind == BlockKind.SLSTM:
        return R.slstm_train(p["slstm"], h)
    rp = p["rec"]
    gate = F.gelu(h @ rp["w_branch_gate"], approximate="tanh")
    lin = R.temporal_conv_train(rp, h @ rp["w_branch_lin"], cfg.conv_width)
    return (gate * R.rglru_train(rp, lin)) @ rp["w_out"]


def _cross_attend(cfg: ArchConfig, p: Dict[str, Any], x: torch.Tensor,
                  positions: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """A decoder layer's cross-attention block: x plus attention of
    rms_norm(x, ln_x) over K and V projected from `enc_out` (B, frames,
    d_model) by `xattn`, in the promoted dtype of the two (a f32 encoder
    output gives f32 K and V under bf16 weights, as the reference's `@`)."""
    b, frames, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    ek, ev = (L.split_heads(L.mm(enc_out, p["xattn"][w]), hkv)
              for w in ("wk", "wv"))
    out, _ = L.attention(cfg, p["xattn"], L.rms_norm(x, p["ln_x"]),
                         positions, cross_kv=(ek, ev))
    return x + out


def _layer_apply(cfg: ArchConfig, kind: BlockKind, p: Dict[str, Any],
                 x: torch.Tensor, positions: torch.Tensor, mesh_axes=None,
                 enc_out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: (x, aux loss), x hinted batch-sharded on the way out.
    Only a LOCAL_ATTN block attends within `cfg.sliding_window`, as the
    reference's; with `enc_out` an attention block attends over it after
    its self-attention; a recurrent block adds its mixer's output, then its
    MLP where it has one."""
    # Each branch's output is hinted as the residual stream is, so that a
    # row-parallel product's partial sums are all-reduced: DTensor would
    # rather scatter them along the hidden dim, and every later product
    # would then gather its weight. Each branch's input has its gradient's
    # partial sums all-reduced likewise (`_grad_settled`).
    def res(y):
        return _shard(y, mesh_axes, ("data", None, None))

    h = _grad_settled(L.rms_norm(x, p["ln1"]), mesh_axes)
    aux = torch.zeros((), device=x.device)
    if kind not in _ATTENTION:
        x = x + res(_recurrent_apply(cfg, kind, p, h))
        if "mlp" in p:
            x = x + res(L.mlp(p["mlp"], _grad_settled(
                L.rms_norm(x, p["ln2"]), mesh_axes)))
    else:
        window = cfg.sliding_window if kind == BlockKind.LOCAL_ATTN else None
        attn_out, _ = L.attention(cfg, p["attn"], h, positions,
                                  sliding_window=window)
        x = x + res(attn_out)
        if enc_out is not None:
            x = _cross_attend(cfg, p, x, positions, enc_out)
        ffn_out, aux = _ffn(cfg, kind, p, _grad_settled(
            L.rms_norm(x, p["ln2"]), mesh_axes), mesh_axes)
        if ffn_out is not None:
            x = x + res(ffn_out)
    return res(x), aux


def _grad_settled(t: torch.Tensor, mesh_axes) -> torch.Tensor:
    """t as it is, its gradient with pending partial sums all-reduced
    (`DTensor.from_local` brings a gradient back to its placements), under
    the hints; DTensor would otherwise carry the partial sums of a
    column-parallel product's input gradient on, and gather the weights
    of the products before it."""
    if mesh_axes is None or not hasattr(t, "device_mesh"):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _build_positions(cfg: ArchConfig, b: int, s: int,
                     device: "str | torch.device") -> torch.Tensor:
    """(B, S) int32 positions 0..S-1; under M-RoPE (3, B, S), the
    reference's layout: the first nv = `cfg.n_vision_tokens` positions form
    a (t = 0, h, w) grid of width int(sqrt(nv)), then text continues with
    t = h = w = 1, 2, ... (standard RoPE for text)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)
    if cfg.mrope_sections is None:
        return pos[None, :].expand(b, s)
    nv = cfg.n_vision_tokens
    if s < nv:
        raise ValueError(f"{cfg.name}: {s} positions, fewer than the {nv} "
                         "vision tokens")
    grid_w = max(1, int(nv ** 0.5))
    vis = torch.arange(nv, dtype=torch.int32, device=device)
    text = torch.arange(1, s - nv + 1, dtype=torch.int32, device=device)
    ids = torch.stack([torch.cat([torch.zeros_like(vis), text]),
                       torch.cat([vis // grid_w, text]),
                       torch.cat([vis % grid_w, text])])
    return ids[:, None, :].expand(3, b, s)


def _logits(cfg: ArchConfig, params: Dict[str, Any],
            x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.matmul(x, head)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _encoder_layer(cfg: ArchConfig, p: Dict[str, Any], e: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, routed as the
    reference routes it through `cross_kv` against itself (no RoPE, no
    mask), then the MLP."""
    b, frames, _ = e.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    h = L.rms_norm(e, p["ln1"])
    ek, ev = (L.split_heads(L.mm(h, p["attn"][w]), hkv)
              for w in ("wk", "wv"))
    out, _ = L.attention(cfg, p["attn"], h, positions, cross_kv=(ek, ev))
    e = e + out
    if "mlp" in p:
        e = e + L.mlp(p["mlp"], L.rms_norm(e, p["ln2"]))
    return e


@on_mesh
def encode(cfg: ArchConfig, params: Dict[str, Any],
           audio_embeds: torch.Tensor, mesh_axes=None) -> torch.Tensor:
    """The bidirectional encoder over precomputed frontend frames
    `audio_embeds` (B, frames, d_model), as the reference's `encode`:
    `audio_proj` (multiplied in the promoted dtype, then rounded to the
    frames' dtype), each encoder layer (`_encoder_layer`; one flash launch
    each, non-causal, Sq = Sk = frames, or the decode kernel at one frame
    without autograd), then `enc_norm`. The activations keep the frames'
    dtype: the f32 frames of `launch.serve.serve` run a bf16 model's
    encoder in f32, as in the reference. With `cfg.remat` under autograd
    each layer goes through `torch.utils.checkpoint`, as `forward`'s do.
    Returns (B, frames, d_model); compute it once per request batch and
    pass it to every `decode_step`. With `mesh_axes` the projected frames
    are hinted batch-sharded, as the reference's."""
    b, frames = audio_embeds.shape[:2]
    e = L.mm(audio_embeds, params["audio_proj"]).to(audio_embeds.dtype)
    e = _shard(e, mesh_axes, ("data", None, None))
    positions = _replicated(torch.arange(
        frames, dtype=torch.int32, device=e.device)[None, :].expand(
            b, frames), e)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params["enc_layers"]:
        if remat:
            e = checkpoint(_encoder_layer, cfg, p, e, positions,
                           use_reentrant=False)
        else:
            e = _encoder_layer(cfg, p, e, positions)
    return L.rms_norm(e, params["enc_norm"])


def needs_audio(cfg: ArchConfig,
                audio_embeds: Optional[torch.Tensor]) -> bool:
    """Whether `forward` runs the encoder: True for an encoder-decoder
    config, which then needs `audio_embeds` (ValueError without them,
    where the reference asserts); False otherwise, `audio_embeds` or
    not."""
    if cfg.is_enc_dec and audio_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: forward needs "
                         "audio_embeds (B, frames, d_model), the encoder's "
                         "frames")
    return cfg.is_enc_dec


def _replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """t, made alike on every rank, as a replicated DTensor on `like`'s
    mesh where `like` is a DTensor, else t: positions that autograd saves
    for the backward (RoPE's angles), which runs without the implicit
    replication of `on_mesh`."""
    if not hasattr(like, "device_mesh"):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _embed(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
           vision_embeds: Optional[torch.Tensor], mesh_axes=None) -> tuple:
    """The decoder's input: (x (B, S, d_model), positions), the first
    n_vision_tokens embeddings replaced by the projected `vision_embeds`
    where the config has a vision frontend and they are given; with
    `mesh_axes` the embeddings are hinted batch-sharded before the vision
    input goes in, as in the reference."""
    b, s = tokens.shape
    # `F.embedding`, not indexing: the same rows, and its backward is the
    # embedding's own operator, for which DTensor has a rule in every torch
    # the port meets (the index_put of indexing's backward has none in
    # 2.11 for tokens sharded over the data axes).
    x = _shard(F.embedding(tokens, params["embed"]), mesh_axes,
               ("data", None, None))
    nv = cfg.n_vision_tokens
    if nv and vision_embeds is not None:
        if vision_embeds.shape != (b, nv, cfg.d_model):
            raise ValueError(f"vision_embeds must be ({b}, {nv}, "
                             f"{cfg.d_model}), got "
                             f"{tuple(vision_embeds.shape)}")
        vis = (vision_embeds.float() @ params["vision_proj"].float()).to(
            x.dtype)
        x = torch.cat([vis, x[:, nv:]], dim=1)
    return x, _replicated(_build_positions(cfg, b, s, x.device), x)


@on_mesh
def forward(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None,
            audio_embeds: Optional[torch.Tensor] = None,
            mesh_axes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int on the params' device → (logits (B, S, V), aux
    loss f32: the sum of the MoE layers', 0 for dense and recurrent
    stacks). One flash-attention launch per attention layer on the card,
    and with `cfg.remat` under autograd one more per such layer in the
    backward's recompute.

    With `cfg.n_vision_tokens` = nv, `vision_embeds` (B, nv, d_model), of
    any float dtype, projected by `vision_proj` replace the first nv token
    embeddings. The projection promotes as the reference's does (f32
    embeds times bf16 weights are a f32 product in JAX): it runs in f32
    and rounds once to the activation dtype. As in the reference,
    `vision_embeds` is ignored by a config without a vision frontend, and
    a vision config without it attends with the same positions and mask
    over the token embeddings alone.

    An encoder-decoder config (`cfg.is_enc_dec`) needs `audio_embeds`
    (B, frames, d_model), which `encode` runs first (ValueError without
    them, where the reference asserts); every decoder layer then attends
    over the encoder output, one more flash launch a layer (non-causal, Sq
    = S, Sk = frames). A config without an encoder ignores
    `audio_embeds`, as the reference's does.

    With `mesh_axes` and DTensor params and tokens, the activations are
    hinted at the reference's points (`_shard`) and the logits end
    batch-sharded with the vocabulary over "model"."""
    x, positions = _embed(cfg, params, tokens, vision_embeds, mesh_axes)
    enc_out = (encode(cfg, params, audio_embeds, mesh_axes)
               if needs_audio(cfg, audio_embeds) else None)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), device=x.device)
    for kind, p in zip(cfg.blocks(), params["layers"]):
        if remat:
            x, aux = checkpoint(_layer_apply, cfg, kind, p, x, positions,
                                mesh_axes, enc_out, use_reentrant=False)
        else:
            x, aux = _layer_apply(cfg, kind, p, x, positions, mesh_axes,
                                  enc_out)
        aux_total = aux_total + aux
    return _shard(_logits(cfg, params, x), mesh_axes,
                  ("data", None, "model")), aux_total


@on_mesh
def lm_loss(cfg: ArchConfig, params: Dict[str, Any], tokens: torch.Tensor,
            labels: torch.Tensor, vision_embeds=None,
            audio_embeds=None, mesh_axes=None) -> torch.Tensor:
    """Mean next-token NLL (+ 0.01 × aux), in f32 over the vocabulary."""
    logits, aux = forward(cfg, params, tokens, vision_embeds, audio_embeds,
                          mesh_axes)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = _settled(torch.gather(logits, -1, labels.long()[..., None]))
    return torch.mean(logz - gold[..., 0]) + 0.01 * aux


def _settled(t: torch.Tensor) -> torch.Tensor:
    """t with a DTensor's pending reductions done (its partial placements
    replicated); a plain tensor as it is. A gather over the vocabulary
    sharded by the hints leaves a masked partial result that must be
    reduced at its own rank, before it is indexed."""
    if not hasattr(t, "device_mesh"):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


# --------------------------------------------------------------------------
# Decode (serve_step): one new token against the KV cache
# --------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype: Optional[torch.dtype] = None, *,
                      device: "str | torch.device" = "cuda"
                      ) -> Dict[str, Any]:
    """Per-layer decode state on `device` and the position of the next
    token, a Python int. Attention layers hold KV caches (B, n_kv_heads, L,
    hd) in `dtype` (`cfg.dtype` when None, as in the reference): an ATTN or
    MOE layer's holds L = max_len positions; a LOCAL_ATTN layer's is a ring
    of L = min(sliding_window or max_len, max_len) slots, beside
    "slot_pos" (L,) int32, the position each slot holds (-1: none yet), as
    the reference keeps it. Recurrent layers hold the reference's O(1)
    state: f32 whatever `dtype` (the mLSTM's c, n, m; the sLSTM's c, n, h,
    m; the RG-LRU's h), but the RG-LRU's conv window (B, conv_width - 1,
    W), in `dtype`."""
    dt = dtype or _dtype(cfg)
    layers: List[Dict[str, torch.Tensor]] = []
    for kind in cfg.blocks():
        if kind == BlockKind.MLSTM:
            layers.append(R.mlstm_init_state(
                batch, cfg.n_heads, cfg.d_model // cfg.n_heads,
                device=device))
            continue
        if kind == BlockKind.SLSTM:
            layers.append(R.slstm_init_state(batch, cfg.d_model,
                                             device=device))
            continue
        if kind == BlockKind.RGLRU:
            w = cfg.lru_width or cfg.d_model
            layers.append({
                "h": R.rglru_init_state(batch, w, device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt,
                                    device=device)})
            continue
        n = max_len
        if kind == BlockKind.LOCAL_ATTN:
            n = min(cfg.sliding_window or max_len, max_len)
        shape = (batch, cfg.n_kv_heads, n, cfg.hd)
        layer = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
        if kind == BlockKind.LOCAL_ATTN:
            layer["slot_pos"] = torch.full((n,), -1, dtype=torch.int32,
                                           device=device)
        layers.append(layer)
    return {"pos": 0, "layers": layers}


def _decode_attn(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                 h: torch.Tensor, state: Dict[str, torch.Tensor], pos: int,
                 posb: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """One-token attention against the cache, updated in place: writes this
    token's K and V at `pos` of a full cache, or at slot pos % L of a ring
    of L slots (and `slot_pos[slot] = pos`), then attends over the first
    `lens` positions or slots, softcapped by `cfg.attn_softcap`.

    A ring attends over its first lens = min(pos + 1, L) slots, which is
    the reference's mask (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos >
    pos - window): the slots written so far are the first min(pos + 1, L)
    and hold the positions (pos - L, pos], all inside the window since L <=
    window; and the softmax does not depend on the order of the slots,
    because each key got RoPE at its own position when it was written."""
    b = h.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = L.split_heads(h @ p["wq"], hq)
    k_new = L.split_heads(h @ p["wk"], hkv)
    v_new = L.split_heads(h @ p["wv"], hkv)
    q = L.apply_rope(q, posb, cfg.rope_theta)
    k_new = L.apply_rope(k_new, posb, cfg.rope_theta)
    slot = pos
    if "slot_pos" in state:
        slot = pos % state["k"].shape[2]
    if _is_sharded(state["k"]):
        out = _decode_attn_local(cfg, state, q[:, :, 0], k_new[:, :, 0],
                                 v_new[:, :, 0], pos, slot, lens)
        return out.reshape(b, 1, hq * hd).to(h.dtype) @ p["wo"]
    if "slot_pos" in state:
        state["slot_pos"][slot] = pos
    state["k"][:, :, slot] = k_new[:, :, 0].to(state["k"].dtype)
    state["v"][:, :, slot] = v_new[:, :, 0].to(state["v"].dtype)
    out = ops.decode_attention(q[:, :, 0], state["k"], state["v"], lens,
                               softcap=cfg.attn_softcap)
    return out.reshape(b, 1, hq * hd).to(h.dtype) @ p["wo"]


# --------------------------------------------------------------------------
# The decode step on sharded caches: each rank writes and reads its own
# shard, and only the token's (B, heads, hd) tensors and the scores move.
# --------------------------------------------------------------------------

class LayerSlice:
    """Entry `lead` (a tuple of leading indices) of a stacked DTensor
    leaf: a decode state's, which the decode step reads and writes on each
    rank's local shard (`read`, `write_local`), or a param's, which
    `models.stacked` reads; never through a DTensor view, which would
    gather the stacked dim first."""

    def __init__(self, leaf: torch.Tensor, lead: Tuple[int, ...]):
        self.leaf, self.lead = leaf, lead

    @property
    def shape(self) -> torch.Size:
        return self.leaf.shape[len(self.lead):]

    def read(self) -> torch.Tensor:
        """The entry as a DTensor, placed as the leaf on its own dims and
        replicated on the mesh dims that shard the stacked dims: there the
        rank whose shard holds the entry gives it and the others zeros,
        summed, so that one entry moves and not the stack. Where the
        stacked dims are not sharded, each rank takes the entry from its
        own shard and nothing moves. Gradients flow back to the holder's
        shard; the other ranks' zeros are an empty slice of their shard
        summed, so that every rank's backward runs the same collectives."""
        from torch.distributed.tensor import DTensor, Partial
        leaf, nl = self.leaf, len(self.lead)
        local = leaf.to_local()
        at = _local_index(leaf, self.lead)
        if at is not None:
            part = local[at]
        elif local.requires_grad:
            part = local.flatten(0, nl - 1)[:0].sum(0)
        else:
            part = local.new_zeros(local.shape[nl:])
        stacked = [pl.is_shard() and pl.dim < nl for pl in leaf.placements]
        placed = [Partial() if st else type(pl)(pl.dim - nl)
                  if pl.is_shard() else pl
                  for pl, st in zip(leaf.placements, stacked)]
        out = DTensor.from_local(part, leaf.device_mesh, placed,
                                 run_check=False, shape=self.shape,
                                 stride=_contiguous_stride(self.shape))
        if not any(stacked):
            return out
        return out.redistribute(leaf.device_mesh, _entry_placements(leaf, nl))


def _is_sharded(t) -> bool:
    return isinstance(t, LayerSlice) or hasattr(t, "device_mesh")


def _leaf_lead(t) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    return (t.leaf, t.lead) if isinstance(t, LayerSlice) else (t, ())


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def _local_box(t: torch.Tensor, placements=None) -> Tuple[list, list]:
    """(local shape, global offset) of this rank's shard of the DTensor t
    under `placements` (t's own by default), each sharded dim split evenly
    over its mesh dims in mesh order, as `launch.sharding` places them.
    DTensor's own `compute_local_shape_and_global_offset` builds the
    offsets as tensors, which a trace cannot read back as ints."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    shape, off = list(t.shape), [0] * t.dim()
    for i, pl in enumerate(placements or t.placements):
        if pl.is_shard():
            d = pl.dim
            if shape[d] % mesh.size(i):
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split evenly over mesh dim {i}")
            shape[d] //= mesh.size(i)
            off[d] += coord[i] * shape[d]
    return shape, off


def _local_index(leaf: torch.Tensor, lead: Tuple[int, ...]):
    """`lead`'s index into the DTensor leaf's local shard, None where the
    shard does not hold it."""
    shape, off = _local_box(leaf)
    if all(off[j] <= i < off[j] + shape[j] for j, i in enumerate(lead)):
        return tuple(i - off[j] for j, i in enumerate(lead))
    return None


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "device_mesh") else t


def write_local(dst, value: torch.Tensor, index: tuple = ()) -> None:
    """dst[lead + index] = value for `dst` a DTensor or a `LayerSlice` of
    one, each rank writing the part its local shard holds, so that none of
    dst moves: `index` holds ints and full slices over the leading dims
    after the lead, `value` (a DTensor, or a plain tensor taken as the
    same on every rank) has the selected part's global shape. A rank whose
    shard holds none of it writes nothing; every rank must call. A DTensor
    value of a whole entry (a recurrent layer's new state) is placed as
    `LayerSlice.read` places the entry and written from its local shard;
    any other is gathered first."""
    leaf, lead = _leaf_lead(dst)
    if not index and hasattr(value, "device_mesh") and \
            value.device_mesh == leaf.device_mesh:
        value = value.redistribute(leaf.device_mesh,
                                   _entry_placements(leaf, len(lead)))
        at = _local_index(leaf, lead)
        if at is not None:
            leaf.to_local()[at] = value.to_local().to(leaf.dtype)
        return
    full = _full(value)
    index = lead + tuple(index)
    shape, off = _local_box(leaf)
    local_idx, part = [], []
    for dim in range(leaf.dim()):
        i = index[dim] if dim < len(index) else slice(None)
        lo, n = off[dim], shape[dim]
        if isinstance(i, int):
            if not lo <= i < lo + n:
                return
            local_idx.append(i - lo)
        else:
            local_idx.append(slice(None))
            part.append(slice(lo, lo + n))
    leaf.to_local()[tuple(local_idx)] = full[tuple(part)].to(leaf.dtype)


def _entry_placements(leaf: torch.Tensor, nl: int) -> list:
    """The placements of an entry of the DTensor leaf's first nl dims, as
    `LayerSlice.read` gives it: the leaf's moved down nl dims, replicated
    on the mesh dims that shard one of those nl dims."""
    from torch.distributed.tensor import Replicate, Shard
    return [(Replicate() if pl.dim < nl else Shard(pl.dim - nl))
            if pl.is_shard() else pl for pl in leaf.placements]


def _decode_attn_local(cfg: ArchConfig, state: Dict[str, Any],
                       q: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, pos: int, slot: int,
                       lens: torch.Tensor) -> torch.Tensor:
    """`_decode_attn`'s write and attention on DTensor caches (B, n_kv, L,
    hd), or `LayerSlice`s of stacked ones, placed as `launch.sharding.
    state_pspecs` places them: q (B, hq, hd), k_new and v_new (B, n_kv,
    hd) are gathered (a token's worth) and each rank

      * writes the slot of its own shard (and `slot_pos`'s, where it holds
        the slot), as the reference's GSPMD updates its slice in place;
      * attends over the part of its shard it works on: its shard's rows,
        split further by batch on the mesh dims that replicate the cache
        (where the batch divides), none where it holds another layer of a
        stack sharded by layer. With whole head dims that is the decode
        kernel on local tensors; with the head dim sharded, the two
        kernels of the decode over a slice of it, the partial scores
        summed over the head dim's mesh dims between them
        (`_decode_attn_split_hd`), so that the cache never moves;
      * returns its part as a DTensor (B, hq, hd), batch-sharded where the
        work was, else replicated (summed from the rank that holds the
        layer)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    leaf, lead = _leaf_lead(state["k"])
    mesh, nl = leaf.device_mesh, len(lead)
    b_all, hq, hd = q.shape
    n_kv = k_new.shape[1]
    write_local(state["k"], k_new, (slice(None), slice(None), slot))
    write_local(state["v"], v_new, (slice(None), slice(None), slot))
    if "slot_pos" in state:
        write_local(state["slot_pos"], torch.tensor(
            pos, dtype=torch.int32, device=leaf.to_local().device), (slot,))

    # The part this rank attends over: its shard, the batch split further
    # on the mesh dims that replicate the cache.
    work = list(leaf.placements)
    split = 1
    for i, pl in enumerate(work):
        if pl.is_replicate() and b_all % (split * mesh.size(i)) == 0:
            work[i], split = Shard(nl), split * mesh.size(i)
        elif pl.is_shard(nl):
            split *= mesh.size(i)
    if any(pl.is_shard(nl + 2) for pl in work):
        raise ValueError("a cache sharded along its positions is not "
                         "supported (launch.sharding.state_pspecs never "
                         "shards them)")
    shape, off = _local_box(leaf, work)
    b0, bl, h0, hl, d0, dl = (off[nl], shape[nl], off[nl + 1],
                              shape[nl + 1], off[nl + 3], shape[nl + 3])
    group = hq // n_kv
    qb = _full(q).reshape(b_all, n_kv, group, hd)[
        b0:b0 + bl, h0:h0 + hl, :, d0:d0 + dl].contiguous()
    hd_dims = [i for i, pl in enumerate(work) if pl.is_shard(nl + 3)]
    at = _local_index(leaf, lead)
    if at is not None:
        l_off = _local_box(leaf)[1]
        rows = slice(b0 - l_off[nl], b0 - l_off[nl] + bl)
        kb = leaf.to_local()[at][rows]
        vb = _leaf_lead(state["v"])[0].to_local()[at][rows]
        lb = lens[b0:b0 + bl]
        if hd_dims:
            out = _decode_attn_split_hd(cfg, qb, kb, vb, lb, hd, mesh,
                                        hd_dims)
        else:
            out = ops.decode_attention(
                qb.reshape(bl, hl * group, hd), kb, vb, lb,
                softcap=cfg.attn_softcap).reshape(bl, hl, group, hd)
    else:
        out = qb.new_zeros((bl, hl, group, dl))
    dims = {nl: Shard(0), nl + 1: Shard(1), nl + 3: Shard(3)}
    placed = [Partial() if nl and pl.is_shard(0) else
              dims[pl.dim] if pl.is_shard() else Replicate() for pl in work]
    out = DTensor.from_local(out, mesh, placed, run_check=False,
                             shape=(b_all, n_kv, group, hd),
                             stride=(n_kv * group * hd, group * hd, hd, 1))
    out = out.redistribute(mesh, [pl if pl == Shard(0) else Replicate()
                                  for pl in placed])
    return out.reshape(b_all, hq, hd)


def _decode_attn_split_hd(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lens: torch.Tensor, hd: int,
                          mesh, mesh_dims: List[int]) -> torch.Tensor:
    """The decode on a slice of the head dim: q (B, n_kv, group, d), k, v
    (B, n_kv, L, d) for d of the hd. The partial scores of the slice
    (`ops.decode_scores`) are summed over `mesh_dims`, the mesh dims that
    shard the head dim, and softmaxed and applied to the slice of V
    (`ops.decode_softmax_v`): the output's d slice."""
    from torch.distributed import _functional_collectives as funcol
    s = ops.decode_scores(q, k, lens)
    for i in mesh_dims:
        s = funcol.all_reduce(s, "sum", (mesh, i))
    return ops.decode_softmax_v(s, v, lens, 1.0 / hd ** 0.5,
                                cfg.attn_softcap)


def _recurrent_step(cfg: ArchConfig, kind: BlockKind, p: Dict[str, Any],
                    h: torch.Tensor, st: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A recurrent block's mixer for one token: (y (B, 1, D), new state)."""
    if kind == BlockKind.MLSTM:
        return R.mlstm_step(p["mlstm"], h, st, cfg.n_heads)
    if kind == BlockKind.SLSTM:
        return R.slstm_step(p["slstm"], h, st)
    rp = p["rec"]
    gate = F.gelu(h @ rp["w_branch_gate"], approximate="tanh")
    lin, conv = R.temporal_conv_step(rp, h @ rp["w_branch_lin"], st["conv"],
                                     cfg.conv_width)
    rec, h_st = R.rglru_step(rp, lin, st["h"])
    return (gate * rec) @ rp["w_out"], {"h": h_st, "conv": conv}


@on_mesh
def decode_step(cfg: ArchConfig, params: Dict[str, Any], token: torch.Tensor,
                state: Dict[str, Any], enc_out: Optional[torch.Tensor] = None,
                mesh_axes=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token (B, 1) int → (logits (B, 1, V), new state).

    The caches are updated in place (the reference returns new arrays), so
    the new state holds the same cache tensors; a recurrent layer's state
    is replaced by new tensors, as the reference's; `pos` advances by one.
    One decode-attention launch per attention layer on the card. `lens` is
    filled on the device once per step for each cache length, with no host
    sync: pos + 1 for a full cache, min(pos + 1, L) for a ring of L slots.
    Only the full caches bound `pos`; a stack of rings and recurrent
    layers alone has no bound, as in the reference. An MOE layer routes the
    step's B tokens together, its capacity reckoned from T = B, as the
    reference's `moe_ffn` does.

    With `enc_out` (`encode`'s output) each decoder layer that has
    `xattn` attends over it after its self-attention, K and V projected
    from it again on every step, as in the reference: the decode kernel
    with lens = frames, one more launch a layer. Without it the
    cross-attention blocks are skipped, as the reference skips them.
    `mesh_axes` is taken and, as in the reference, read nowhere.
    """
    logits, layers = decode_layers(cfg, params, params["layers"],
                                   state["layers"], token, state["pos"],
                                   enc_out)
    return logits, {"pos": state["pos"] + 1, "layers": layers}


def decode_layers(cfg: ArchConfig, params: Dict[str, Any],
                  layer_params: List[Dict[str, Any]],
                  layer_states: List[Dict[str, torch.Tensor]],
                  token: torch.Tensor, pos: int,
                  enc_out: Optional[torch.Tensor] = None) -> tuple:
    """`decode_step`'s body over the decoder layers' params and states in
    layer order (`models.stacked` passes views of its stacked leaves):
    (logits (B, 1, V), the layers' new states). Caches are written in
    place; a recurrent layer's new state is a new dict of new tensors."""
    b = token.shape[0]
    full = [st["k"].shape[2] for st in layer_states
            if "k" in st and "slot_pos" not in st]
    if pos < 0 or (full and pos >= min(full)):
        raise ValueError(f"position {pos} is outside the cache of "
                         f"{min(full) if full else 'any length'}")
    # A vocabulary-sharded table gives masked partial rows: summed here,
    # as the prefill's hint sums them.
    x = _settled(F.embedding(token, params["embed"]))
    kinds = cfg.blocks()
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    lens: Dict[int, torch.Tensor] = {}       # by valid length
    layers = list(layer_states)
    for li, p in enumerate(layer_params):
        x, layers[li] = decode_layer(cfg, kinds[li], p, layers[li], x, pos,
                                     posb, lens, enc_out)
    return _logits(cfg, params, x), layers


def decode_layer(cfg: ArchConfig, kind: BlockKind, p: Dict[str, Any],
                 st: Dict[str, torch.Tensor], x: torch.Tensor, pos: int,
                 posb: torch.Tensor, lens: Dict[int, torch.Tensor],
                 enc_out: Optional[torch.Tensor] = None) -> tuple:
    """One layer of `decode_layers` on x (B, 1, d_model): (x, the layer's
    new state), a cache written in place. `posb` (B, 1) holds `pos`; `lens`
    caches the (B,) valid lengths by value across a step's layers."""
    h = L.rms_norm(x, p["ln1"])
    if kind not in _ATTENTION:
        st = {name: t.read() if isinstance(t, LayerSlice) else t
              for name, t in st.items()}
        y, st = _recurrent_step(cfg, kind, p, h, st)
        x = x + R.batch_only(y)
        if "mlp" in p:
            x = x + R.batch_only(L.mlp(p["mlp"], L.rms_norm(x, p["ln2"])))
        return x, st
    n = pos + 1
    if "slot_pos" in st:
        n = min(n, st["k"].shape[2])
    if n not in lens:
        lens[n] = torch.full((x.shape[0],), n, dtype=torch.int32,
                             device=x.device)
    # Each branch's output is summed and replicated but for its batch
    # (`recurrent.batch_only`), a token's worth: kept partial or sharded
    # along the hidden dim, the residual would make the next products
    # gather their weights.
    x = x + R.batch_only(_decode_attn(cfg, p["attn"], h, st, pos, posb,
                                      lens[n]))
    if enc_out is not None and "xattn" in p:
        x = _cross_attend(cfg, p, x, posb, enc_out)
    ffn_out, _ = _ffn(cfg, kind, p, L.rms_norm(x, p["ln2"]))
    if ffn_out is not None:
        x = x + R.batch_only(ffn_out)
    return x, st
