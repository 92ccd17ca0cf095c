"""Optimizers as functional updates on dicts of tensors.

The port of `repro.train.optim`: the same AdamW (b2 = 0.95, decay applied
as lr·(update + wd·p)) and Adafactor (factored second moment, no first
moment, update clipping), with the same hyperparameters and state layout,
not `torch.optim`'s. Updates run under `torch.no_grad()`, compute in
float32 and return new tensors in each parameter's dtype; nothing is
updated in place. The JAX package has no kernel for them, so neither has
the port: they are elementwise PyTorch.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------- AdamW ----

def adamw_init(params: Params) -> dict:
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()},
        "step": 0,
    }


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: dict, lr=1e-3,
                 b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.01) -> Tuple[Dict[str, torch.Tensor], dict]:
    step = state["step"] + 1
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        p32 = p.to(torch.float32)
        m = b1 * state["m"][k] + (1 - b1) * g32
        v = b2 * state["v"][k] + (1 - b2) * torch.square(g32)
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[k] = (p32 - lr * (update + weight_decay * p32)).to(p.dtype)
        new_m[k], new_v[k] = m, v
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

    return {"stats": {k: stat(p) for k, p in params.items()}, "step": 0}


@torch.no_grad()
def adafactor_update(params: Params, grads: Params, state: dict, lr=1e-2,
                     decay=0.8, eps=1e-30, clip_threshold=1.0,
                     weight_decay=0.0) -> Tuple[Dict[str, torch.Tensor], dict]:
    step = state["step"] + 1
    beta = 1.0 - step ** -decay
    new_p, new_s = {}, {}
    for k, p in params.items():
        s = state["stats"][k]
        g32 = grads[k].to(torch.float32)
        g2 = torch.square(g32) + eps
        if _factored(p.shape):
            vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            r = (vr / torch.clamp_min(denom, eps))[..., None]
            u = (g32 * torch.rsqrt(torch.clamp_min(r, eps))
                 * torch.rsqrt(torch.clamp_min(vc[..., None, :], eps)))
            new_s[k] = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g32 * torch.rsqrt(torch.clamp_min(v, eps))
            new_s[k] = {"v": v}
        # Update clipping (RMS ≤ clip_threshold).
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        p32 = p.to(torch.float32)
        new_p[k] = (p32 - lr * (u + weight_decay * p32)).to(p.dtype)
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
