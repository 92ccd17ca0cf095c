"""Sharding rules: param/activation/state PartitionSpecs for any mesh, as
`repro.launch.sharding` gives them, and the DTensor placements they mean.

Generic, divisibility-checked rules — the policy MaxText-class frameworks
use, as name-pattern preferences with automatic fallback:

  * 2D weights: columns over "model" (TP), rows over ("pod","data") (FSDP/
    ZeRO — optimizer state shards with the params).
  * MoE expert banks (E, d, f): experts over "model" (EP) when E divides,
    else tensor-parallel inside the expert; d over data axes.
  * embeddings: vocab over "model" when divisible, else d_model.
  * norms/scalars: replicated.
  * KV caches: batch over data axes, kv-heads over "model" when divisible,
    else head_dim.

Preference order is tried first; any dim that does not divide falls back
(None). A mesh is anything with `mesh_dim_names` and `shape`: a
`DeviceMesh` or `launch.mesh.AbstractMesh`. Param paths are the
reference's (`scan/0/attn/wq`), walked over the port's dicts and lists.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

DATA_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of names (the dim split over their product, major first). As
    `jax.sharding.PartitionSpec` keeps them: a list becomes a tuple and a
    one-name tuple its name, so the single-pod mesh's data axes, fitted
    to ("data",), read "data"."""

    def __new__(cls, *entries):
        def canonical(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, tuple(canonical(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= _axis_size(sizes, a)
        return out
    return sizes.get(axis, 0)


def _fit(mesh, shape: Sequence[int], spec: Sequence) -> P:
    """P(spec) with non-dividing axes dropped, and axes the mesh lacks."""
    sizes = _sizes(mesh)
    out = []
    for dim, axis in zip(shape, spec):
        size = _axis_size(sizes, axis)
        if size == 0:
            # axis not in this mesh (e.g. "pod" on single-pod): drop it
            if isinstance(axis, (tuple, list)):
                kept = tuple(a for a in axis if a in sizes)
                size = _axis_size(sizes, kept)
                axis = kept if kept else None
            else:
                axis = None
                size = 1
        if size > 1 and dim % size == 0:
            out.append(axis if not isinstance(axis, (tuple, list))
                       else tuple(axis))
        else:
            out.append(None)
    return P(*out)


# Shard over data axes only in FSDP mode, else replicate. Optimizer state
# always resolves FSDP=True (ZeRO-1).
FSDP = "__fsdp__"

# (regex on param path, ordered spec preferences per rank): the first rule
# match wins; within a rule, the first preference whose sharded dims all
# divide wins; else the last preference is per-dim fitted.
_PARAM_RULES: List[Tuple[str, Dict[int, Sequence]]] = [
    # MoE expert banks: EP over model preferred; when E doesn't divide the
    # model axis, tensor-parallel inside the expert instead.
    (r"moe/w_(gate|up)$",   {3: [("model", FSDP, None), (None, FSDP, "model")]}),
    (r"moe/w_down$",        {3: [("model", None, FSDP), (None, "model", FSDP)]}),
    (r"moe/w_router$",      {2: [(FSDP, None)]}),
    # Attention projections: column-parallel in, row-parallel out.
    (r"(attn|xattn)/w[qkv]$", {2: [(FSDP, "model")]}),
    (r"(attn|xattn)/wo$",     {2: [("model", FSDP)]}),
    # Dense MLP.
    (r"mlp/w_(gate|up)$",   {2: [(FSDP, "model")]}),
    (r"mlp/w_down$",        {2: [("model", FSDP)]}),
    # Recurrent blocks.
    (r"mlstm/w[qkv]$",      {2: [(FSDP, "model")]}),
    (r"mlstm/w[if]$",       {2: [(FSDP, None)]}),
    (r"mlstm/wo$",          {2: [("model", FSDP)]}),
    (r"slstm/(wz|wi_g|wf_g|wo_g)$", {2: [(FSDP, "model")]}),
    (r"slstm/r[zifo]$",     {2: [(FSDP, "model")]}),
    (r"slstm/wo$",          {2: [("model", FSDP)]}),
    (r"rec/w_branch_(gate|lin)$", {2: [(FSDP, "model")]}),
    (r"rec/w_(rec|in)_gate$",     {2: [(FSDP, "model")]}),
    (r"rec/w_out$",         {2: [("model", FSDP)]}),
    (r"rec/conv_w$",        {2: [(None, "model")]}),
    (r"rec/(conv_b|lambda)$", {1: [("model",)]}),
    # Embeddings / head: vocab over model (sharded softmax) preferred.
    (r"embed$",             {2: [("model", None)]}),
    (r"lm_head$",           {2: [(None, "model")]}),
    (r"(vision|audio)_proj$", {2: [(FSDP, "model")]}),
]


def _resolve(spec: Sequence, fsdp: bool) -> Sequence:
    return [DATA_AXES if a == FSDP and fsdp
            else (None if a == FSDP else a) for a in spec]


def _fully_fits(mesh, shape, spec) -> bool:
    fitted = _fit(mesh, shape, spec)
    want = [a for a in spec if a is not None]
    got = [a for a in fitted if a is not None]
    return len(want) == len(got)


def _shape(leaf) -> tuple:
    """A leaf's shape; () for a Python scalar (the port's `step` and
    `pos` counters, 0-d arrays in the reference)."""
    return tuple(getattr(leaf, "shape", ()))


def _map_with_path(fn, tree, path: str = ""):
    """fn(path, leaf) over a tree of dicts, lists and tuples (a
    PartitionSpec is a leaf), the path's parts joined by "/" as the
    reference's `_path_str` joins them."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(
            _map_with_path(fn, v, f"{path}/{i}" if path else str(i))
            for i, v in enumerate(tree))
    return fn(path, tree)


def param_pspec(path: str, shape: Sequence[int], mesh,
                fsdp: bool = False) -> P:
    rank = len(shape)
    for pattern, by_rank in _PARAM_RULES:
        if re.search(pattern, path) and rank in by_rank:
            prefs = [_resolve(p, fsdp) for p in by_rank[rank]]
            for pref in prefs:
                if _fully_fits(mesh, shape, pref):
                    return _fit(mesh, shape, pref)
            return _fit(mesh, shape, prefs[-1])
    if rank >= 2:
        spec = [None] * rank
        spec[0] = DATA_AXES if fsdp else None
        spec[-1] = "model"
        fitted = _fit(mesh, shape, spec)
        if all(a is None for a in fitted):
            spec2 = [None] * rank
            spec2[0] = "model"
            return _fit(mesh, shape, spec2)
        return fitted
    return P(*([None] * rank))


def tree_pspecs(tree, mesh, fsdp: bool = False):
    """Tree of PartitionSpecs matching `tree` (of tensors, meta ones
    included)."""
    return _map_with_path(
        lambda path, leaf: param_pspec(path, _shape(leaf), mesh, fsdp=fsdp),
        tree)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: for each mesh dim,
    Shard(d) where tensor dim d's entry names it, else Replicate(). A dim
    split over ("pod", "data") is Shard(d) on both, in mesh order, which
    is the spec's major-first order."""
    from torch.distributed.tensor import Replicate, Shard
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                owner[name] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in mesh.mesh_dim_names)


def tree_placements(tree, mesh, fsdp: bool = False):
    """`tree_pspecs` as DTensor placements per leaf (the counterpart of
    the reference's `tree_shardings`)."""
    return _map_with_path(
        lambda path, spec: placements(spec, mesh),
        tree_pspecs(tree, mesh, fsdp=fsdp))


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """The shard shape `spec` implies on `mesh` (every sharded dim
    divides, as `_fit` leaves them)."""
    sizes = _sizes(mesh)
    return tuple(dim // _axis_size(sizes, entry)
                 for dim, entry in zip(shape, spec)) + tuple(
        shape[len(spec):])


def batch_pspec(shape: Sequence[int], mesh) -> P:
    """Batch arrays: leading dim over data axes when divisible."""
    spec = [None] * len(shape)
    spec[0] = DATA_AXES
    return _fit(mesh, shape, spec)


def opt_state_pspecs(opt_state, param_specs, mesh):
    """Optimizer moments shard with ZeRO-1 semantics: always the FSDP
    variant of their parameter's rule. Scalars replicate."""
    out = {}
    for key, sub in opt_state.items():
        if key == "step":
            out[key] = P()
            continue
        if key in ("m", "v", "stats"):
            out[key] = _map_with_path(
                lambda path, leaf: param_pspec(path, _shape(leaf), mesh,
                                               fsdp=True), sub)
            continue
        out[key] = _map_with_path(lambda path, leaf: P(), sub)
    return out


def state_pspecs(state, mesh):
    """Decode-state sharding: caches (B, hkv, S, hd) → batch over data,
    kv-heads over model when divisible else head_dim; recurrent states
    (B, ...) → batch over data, trailing dim over model."""
    def fn(path, leaf):
        shape = _shape(leaf)
        if len(shape) == 4:   # kv cache
            spec = [DATA_AXES, "model", None, None]
            fitted = _fit(mesh, shape, spec)
            if fitted[1] is None:
                fitted = _fit(mesh, shape, [DATA_AXES, None, None, "model"])
            return fitted
        if len(shape) == 0:
            return P()
        spec = [None] * len(shape)
        spec[0] = DATA_AXES
        if len(shape) >= 2:
            spec[-1] = "model"
        return _fit(mesh, shape, spec)
    return _map_with_path(fn, state)
