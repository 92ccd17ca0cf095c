"""Optimizers as functional updates on dicts of tensors.

The port of `repro.train.optim`: the same AdamW (b2 = 0.95, decay applied
as lr·(update + wd·p)) and Adafactor (factored second moment, no first
moment, update clipping), with the same hyperparameters and state layout,
not `torch.optim`'s. Params are trees of tensors (dicts and lists, as the
LM's, or a flat dict, as the GCN's); the state mirrors the tree, as the
reference's pytrees do. Updates run under `torch.no_grad()`, compute in
float32 and return new tensors in each parameter's dtype; nothing is
updated in place. The JAX package has no kernel for them, so neither has
the port: they are elementwise PyTorch.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

Params = Any      # a tree of tensors: dicts and lists of them


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` (a tree of dicts and lists), with the
    entries at the same places of `rest`: trees that hold `tree`'s
    structure and may hold subtrees where it holds leaves, as
    `jax.tree_util`'s `flatten_up_to` takes them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _unzip(structure, tree, n: int) -> tuple:
    """`tree` holds an n-tuple at every leaf of `structure` → n trees."""
    return tuple(tree_map(lambda _, t, i=i: t[i], structure, tree)
                 for i in range(n))


# ---------------------------------------------------------------- AdamW ----

def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def adamw_init(params: Params) -> dict:
    return {"m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params), "step": 0}


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: dict, lr=1e-3,
                 b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.01) -> Tuple[Params, dict]:
    step = state["step"] + 1
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return (p32 - lr * (update + weight_decay * p32)).to(p.dtype), m, v

    new_p, new_m, new_v = _unzip(params, tree_map(
        upd, params, grads, state["m"], state["v"]), 3)
    return new_p, {"m": new_m, "v": new_v, "step": step}


# ------------------------------------------------------------ Adafactor ----

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Params) -> dict:
    def stat(p):
        if _factored(p.shape):
            return {   # row and column statistics
                "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                  device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                  dtype=torch.float32, device=p.device),
            }
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    return {"stats": tree_map(stat, params), "step": 0}


@torch.no_grad()
def adafactor_update(params: Params, grads: Params, state: dict, lr=1e-2,
                     decay=0.8, eps=1e-30, clip_threshold=1.0,
                     weight_decay=0.0) -> Tuple[Params, dict]:
    step = state["step"] + 1
    beta = 1.0 - step ** -decay

    def upd(p, g, s):
        # The reference's arithmetic, op for op; the full-size temporaries
        # are updated in place, so a leaf takes three of them at most.
        g32 = g.to(torch.float32)
        g2 = torch.square(g32).add_(eps)
        if _factored(p.shape):
            vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            del g2
            denom = torch.mean(vr, dim=-1, keepdim=True)
            r = (vr / torch.clamp_min(denom, eps))[..., None]
            u = g32 * torch.rsqrt(torch.clamp_min(r, eps))
            u.mul_(torch.rsqrt(torch.clamp_min(vc[..., None, :], eps)))
            new_s = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            del g2
            u = g32 * torch.rsqrt(torch.clamp_min(v, eps))
            new_s = {"v": v}
        # Update clipping (RMS ≤ clip_threshold).
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u.div_(torch.clamp_min(rms / clip_threshold, 1.0))
        p32 = p.to(torch.float32)
        # Added into the decay's temporary, not into u: a DTensor u may be
        # a pending sum, which takes no in-place add of a sharded tensor.
        step = (weight_decay * p32).add_(u).mul_(lr)
        return torch.sub(p32, step, out=step).to(p.dtype), new_s

    new_p, new_s = _unzip(params, tree_map(upd, params, grads,
                                           state["stats"]), 2)
    return new_p, {"stats": new_s, "step": step}


OPTIMIZERS: Dict[str, Tuple[Callable, Callable]] = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}


def make_optimizer(name: str, **hyper):
    init_fn, update_fn = OPTIMIZERS[name]

    def update(params, grads, state):
        return update_fn(params, grads, state, **hyper)

    return init_fn, update
