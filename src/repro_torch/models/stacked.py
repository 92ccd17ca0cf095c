"""Stacked per-layer params and the scan paths of
`repro.models.stacked`.

The reference stacks the params of each position of the arch's block
pattern (its "unit") along a leading axis and runs `lax.scan` over the
repeats, so that XLA compiles one unit, not every layer. Here the scan is
a Python loop over views of the stacked leaves, and the layers are the
unrolled path's own (`transformer._layer_apply`, `_encoder_layer`,
`decode_layers`), so both paths compute the same function on the same
weights. The layout is the reference's:

  * params["scan"][j]: the unit's j-th layer of every repeat, each leaf
    (R, ...), R = n_layers // len(unit);
  * params["rest"]: the n_layers % len(unit) layers after them, unstacked;
  * params["enc_scan"]: the encoder's layers, each leaf (encoder_layers,
    ...), for an encoder-decoder;
  * the other leaves (embed, final_norm, lm_head, enc_norm, vision_proj,
    audio_proj) as in `init_params`.

`init_params_stacked` draws what `init_params` draws from the same
generator; `params_from_numpy_stacked` carries the reference's stacked
tree across; `stack_params` and `unstack_params` convert between the two
layouts. With `cfg.remat` under autograd, `forward_scan` checkpoints each
repeat of the unit and `encode_scan` each encoder layer, as the
reference's scan bodies are checkpointed; the remainder layers are not.
Each path takes the sharding hints (`mesh_axes`) where the reference's
does (`transformer._shard`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig, BlockKind


def unit_kinds(cfg: ArchConfig) -> List[BlockKind]:
    """The block pattern the scan repeats: `cfg.block_pattern`, else the
    first `local_global_pattern` kinds, else the first layer's kind."""
    if cfg.block_pattern:
        return [BlockKind(b) for b in cfg.block_pattern]
    kinds = cfg.blocks()
    if cfg.local_global_pattern:
        return kinds[: cfg.local_global_pattern]
    return kinds[:1]


def group_split(cfg: ArchConfig) -> Tuple[int, int]:
    """(repeats R, remainder layers)."""
    u = len(unit_kinds(cfg))
    return cfg.n_layers // u, cfg.n_layers % u


def _stack(trees: List[Any]) -> Any:
    """The trees' leaves stacked along a new leading axis."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(trees)
    return torch.stack(trees)


def _view(tree: Any, i: int, path: Optional[str] = None) -> Any:
    """Entry i of every stacked leaf: a view of a plain tensor; of a
    DTensor, the entry read from the local shards
    (`transformer.LayerSlice.read`), which moves that one entry where the
    stacked dim is sharded and nothing where it is not, never the whole
    stack. Both carry gradients.

    With `path` (the keys above the tree; the forward paths give it), a
    DTensor entry of one or two dims is then placed over "model" as the
    unstacked layout places that layer's leaf (`launch.sharding.
    param_pspec` on its path, without FSDP): the stacked layout shards
    every leaf's last dim over "model", and with a row-parallel product
    (attn/wo, mlp/w_down) or a norm placed so, DTensor would gather every
    weight that the next product needs. A decode step's products take a
    token each, so without `path` an entry keeps the stacked placement,
    under which DTensor moves the token's activations rather than weights,
    but for a norm's scale, which is replicated (or every product after
    the norm would gather its input again)."""
    if isinstance(tree, Mapping):
        return {k: _view(v, i, None if path is None else
                         f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if not hasattr(tree, "device_mesh"):
        return tree[i]
    from torch.distributed.tensor import Replicate, Shard
    entry = T.LayerSlice(tree, (i,)).read()
    mesh = entry.device_mesh
    if path is not None and entry.dim() <= 2:
        dims = _unstacked_dims(path, tuple(entry.shape),
                               tuple(mesh.mesh_dim_names),
                               tuple(mesh.size(m) for m in range(mesh.ndim)))
        want = [Shard(d) if d >= 0 else Replicate() for d in dims]
        for m, (have, pl) in enumerate(zip(entry.placements, want)):
            if have.is_shard() and pl.is_shard() and have.dim != pl.dim:
                entry = _move_shard(entry, m, pl.dim)
    elif entry.dim() == 1:
        want = [Replicate()] * mesh.ndim
    else:
        return entry
    return entry if want == list(entry.placements) else \
        entry.redistribute(mesh, want)


@torch.compiler.assume_constant_result
def _unstacked_dims(path: str, shape: tuple, names: tuple,
                    sizes: tuple) -> tuple:
    """For each mesh dim (names, sizes), the dim of a layer's leaf (its
    path and shape) that the unstacked layout shards over it, -1 for none,
    by `launch.sharding.param_pspec` without FSDP. A trace takes the result
    as a constant: the rules match paths by regular expressions, which
    dynamo does not trace on every torch the port meets."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import param_pspec
    spec = param_pspec(path, shape, AbstractMesh(sizes, names))
    owner = {name: d for d, entry in enumerate(spec)
             for name in (entry if isinstance(entry, tuple) else (entry,))
             if name is not None}
    return tuple(owner.get(name, -1) for name in names)


def _move_shard(t: torch.Tensor, mesh_dim: int, dim: int) -> torch.Tensor:
    """The DTensor t, sharded on `mesh_dim` along another dim, sharded
    along `dim` instead (which that mesh dim divides, as `param_pspec`
    places it), by one all-to-all of its local shard: DTensor's own
    redistribution falls back to a gather on a CPU mesh. Carries
    gradients."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard
    mesh, src = t.device_mesh, t.placements[mesh_dim].dim
    n = mesh.size(mesh_dim)
    local = t.to_local()
    # Rank j is sent chunk j along `dim`; what it gets is stacked by
    # sender (axis 0), the chunk next (axis 1), then the other dims, src
    # among them at `at`; the senders are then joined into src.
    parts = local.movedim(dim, 0).unflatten(0, (n, -1)).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        parts, None, None, (mesh, mesh_dim)))
    at = 2 + (src if src < dim else src - 1)
    local = got.movedim(0, at - 1).flatten(at - 1, at).movedim(0, dim)
    placed = [Shard(dim) if m == mesh_dim else pl
              for m, pl in enumerate(t.placements)]
    return DTensor.from_local(local, mesh, placed, run_check=False,
                              shape=t.shape, stride=t.stride())


def _group(cfg: ArchConfig, layers: List[Any]) -> Tuple[List[Any], List[Any]]:
    """Per-layer trees in layer order as (scan, rest)."""
    u = len(unit_kinds(cfg))
    r, _ = group_split(cfg)
    scan = [_stack([layers[rep * u + j] for rep in range(r)])
            for j in range(u)] if r else []
    return scan, list(layers[r * u:])


def _layers(cfg: ArchConfig, scan: List[Any], rest: List[Any]) -> List[Any]:
    """The per-layer trees in layer order, views into `scan`."""
    r, _ = group_split(cfg)
    return [_view(unit_j, rep) for rep in range(r) for unit_j in scan] \
        + list(rest)


def stack_params(cfg: ArchConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """`init_params`' layout (tensors or numpy arrays) in the stacked one."""
    out = {k: v for k, v in params.items()
           if k not in ("layers", "enc_layers")}
    out["scan"], out["rest"] = _group(cfg, params["layers"])
    if cfg.is_enc_dec:
        out["enc_scan"] = _stack(params["enc_layers"])
    return out


def unstack_params(cfg: ArchConfig, params: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """The stacked layout in `init_params`' (each layer's leaves views of
    the stacked ones)."""
    out = {k: v for k, v in params.items()
           if k not in ("scan", "rest", "enc_scan")}
    out["layers"] = _layers(cfg, params["scan"], params["rest"])
    if cfg.is_enc_dec:
        out["enc_layers"] = [_view(params["enc_scan"], i)
                             for i in range(cfg.encoder_layers)]
    return out


def init_params_stacked(cfg: ArchConfig,
                        generator: Optional[torch.Generator],
                        device: "str | torch.device" = "cuda"
                        ) -> Dict[str, Any]:
    """The weights `init_params(cfg, generator, device)` draws, stacked:
    the same values, as the reference's `init_params_stacked` draws what
    its `init_params` draws (on the meta device, shapes alone)."""
    return stack_params(cfg, T.init_params(cfg, generator, device))


def params_from_numpy_stacked(cfg: ArchConfig, tree: Mapping[str, Any],
                              device: "str | torch.device"
                              ) -> Dict[str, Any]:
    """Carry the reference's stacked param tree (numpy leaves) onto
    `device`, values and dtypes unchanged; raises where its structure or
    shapes differ from `cfg`'s (`transformer.params_from_numpy`)."""
    flat = unstack_params(cfg, {k: v for k, v in tree.items()})
    return stack_params(cfg, T.params_from_numpy(cfg, flat, device))


@T.on_mesh
def encode_scan(cfg: ArchConfig, params: Dict[str, Any],
                audio_embeds: torch.Tensor, mesh_axes=None) -> torch.Tensor:
    """`transformer.encode` over the stacked encoder layers."""
    enc = {"audio_proj": params["audio_proj"],
           "enc_norm": params["enc_norm"],
           "enc_layers": [_view(params["enc_scan"], i, "")
                          for i in range(cfg.encoder_layers)]}
    return T.encode(cfg, enc, audio_embeds, mesh_axes)


def _unit_apply(cfg: ArchConfig, u_kinds: List[BlockKind],
                unit_params: List[Any], x: torch.Tensor,
                positions: torch.Tensor, mesh_axes=None,
                enc_out: Optional[torch.Tensor] = None) -> tuple:
    """One repeat of the unit, `unit_params[j]` the params of its j-th
    layer: (x, its aux loss)."""
    aux = torch.zeros((), device=x.device)
    for kind, p in zip(u_kinds, unit_params):
        x, a = T._layer_apply(cfg, kind, p, x, positions, mesh_axes, enc_out)
        aux = aux + a
    return x, aux


@T.on_mesh
def forward_scan(cfg: ArchConfig, params: Dict[str, Any],
                 tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None,
                 audio_embeds: Optional[torch.Tensor] = None,
                 mesh_axes=None,
                 last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """`transformer.forward` over stacked params: (logits, aux loss), the
    logits of the last position alone with `last_only` (a serving
    prefill's next token)."""
    x, positions = T._embed(cfg, params, tokens, vision_embeds, mesh_axes)
    enc_out = (encode_scan(cfg, params, audio_embeds, mesh_axes)
               if T.needs_audio(cfg, audio_embeds) else None)
    kinds = unit_kinds(cfg)
    r, _ = group_split(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for rep in range(r):
        unit = [_view(unit_j, rep, "") for unit_j in params["scan"]]
        if remat:
            x, a = checkpoint(_unit_apply, cfg, kinds, unit, x, positions,
                              mesh_axes, enc_out, use_reentrant=False)
        else:
            x, a = _unit_apply(cfg, kinds, unit, x, positions, mesh_axes,
                               enc_out)
        aux = aux + a
    blocks = cfg.blocks()
    for i, p in enumerate(params["rest"]):
        x, a = T._layer_apply(cfg, blocks[r * len(kinds) + i], p, x,
                              positions, mesh_axes, enc_out)
        aux = aux + a
    if last_only:
        x = x[:, -1:]
    # The vocabulary stays sharded over "model" (a sharded softmax in the
    # loss), as in the reference.
    return T._shard(T._logits(cfg, params, x), mesh_axes,
                    ("data", None, "model")), aux


def lm_loss_scan(cfg: ArchConfig, params: Dict[str, Any],
                 tokens: torch.Tensor, labels: torch.Tensor,
                 vision_embeds=None, audio_embeds=None,
                 mesh_axes=None) -> torch.Tensor:
    """Mean next-token NLL (+ 0.01 × aux) of `forward_scan`, in f32, as
    the reference's shard-friendly loss: log Z by the running max, the gold
    logit by the one-hot einsum, which keeps the vocabulary sharded over
    "model" under the hints (no gather of the logits) and sums one nonzero
    product, so it is the gold logit exactly."""
    logits, aux = forward_scan(cfg, params, tokens, vision_embeds,
                               audio_embeds, mesh_axes)
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    onehot = (labels.long()[..., None] == _vocab_ids(cfg, logits, mesh_axes)
              ).float()
    onehot = T._shard(onehot, mesh_axes, ("data", None, "model"))
    gold = torch.einsum("bsv,bsv->bs", logits, onehot)
    return torch.mean(logz - gold) + 0.01 * aux


def _vocab_ids(cfg: ArchConfig, logits: torch.Tensor,
               mesh_axes) -> torch.Tensor:
    """0..V-1 on the logits' device; under the hints a DTensor sharded over
    "model", so that the one-hot is made shard by shard."""
    ids = torch.arange(cfg.vocab, device=logits.device)
    if mesh_axes is None or not hasattr(logits, "device_mesh"):
        return ids
    from torch.distributed.tensor import DTensor, Replicate
    mesh = logits.device_mesh
    ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return T._shard(ids, mesh_axes, ("model",))


def init_decode_state_stacked(cfg: ArchConfig, batch: int, max_len: int,
                              dtype: Optional[torch.dtype] = None, *,
                              device: "str | torch.device" = "cuda"
                              ) -> Dict[str, Any]:
    """`init_decode_state` grouped like the params: state["scan"][j] with
    leaves (R, ...) for unit position j, state["rest"] unrolled."""
    flat = T.init_decode_state(cfg, batch, max_len, dtype, device=device)
    scan, rest = _group(cfg, flat["layers"])
    return {"pos": flat["pos"], "scan": scan, "rest": rest}


@T.on_mesh
def decode_step_scan(cfg: ArchConfig, params: Dict[str, Any],
                     token: torch.Tensor, state: Dict[str, Any],
                     enc_out: Optional[torch.Tensor] = None,
                     mesh_axes=None) -> tuple:
    """`transformer.decode_step` over stacked params and state: (logits,
    new state). The stacked state is updated in place: caches are written
    through views of the stacked tensors, and each recurrent layer's new
    state is copied into its slice; the new state holds the same tensors
    with `pos` advanced by one. `mesh_axes` is taken and, as in the
    reference, read nowhere. A DTensor leaf's layer is a
    `transformer.LayerSlice`, written on each rank's local shard."""
    r, _ = group_split(cfg)
    states = [{k: T.LayerSlice(t, (rep,)) if hasattr(t, "device_mesh")
               else t[rep] for k, t in unit_j.items()}
              for rep in range(r) for unit_j in state["scan"]] \
        + list(state["rest"])
    logits, new = T.decode_layers(
        cfg, params, _layers(cfg, params["scan"], params["rest"]), states,
        token, state["pos"], enc_out)
    for kind, old, st in zip(cfg.blocks(), states, new):
        if kind not in T._ATTENTION:          # a new state: copied back
            for name, t in st.items():
                if isinstance(old[name], T.LayerSlice):
                    T.write_local(old[name], t)
                else:
                    old[name].copy_(t)
    rest = states[r * len(unit_kinds(cfg)):]
    return logits, {"pos": state["pos"] + 1, "scan": state["scan"],
                    "rest": rest}
