"""The paper's own architecture: a GCN with out-of-core aggregation.

Two execution paths per layer, Eq. (4): H' = σ(Ã H W + b):
  * in-core: `a` is a dense tensor and the aggregation is a matmul;
  * out-of-core (AIRES): `a` is a CSR and X = Ã H streams through an
    `AiresSpGEMM` when cfg.out_of_core is set.
Parameters are a plain dict of tensors, ``w{i}`` and ``b{i}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.sparse.formats import CSR


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn_paper"
    feature_dim: int = 256       # paper §V-A
    hidden_dims: Tuple[int, ...] = (256, 256)
    n_classes: int = 32
    out_of_core: bool = False
    device_budget_bytes: int = 1 << 30
    dtype: str = "float32"

    def layer_dims(self) -> list:
        dims = [self.feature_dim, *self.hidden_dims, self.n_classes]
        return list(zip(dims[:-1], dims[1:]))


def gcn_init(cfg: GCNConfig, generator: torch.Generator,
             device: "str | torch.device" = "cuda") -> Dict[str, torch.Tensor]:
    """Random weights N(0, 1/d_in) and zero biases, drawn on the CPU from
    `generator` (so a seed gives the same weights on every device)."""
    dt = getattr(torch, cfg.dtype)
    params = {}
    for i, (din, dout) in enumerate(cfg.layer_dims()):
        w = torch.randn((din, dout), generator=generator) * din ** -0.5
        params[f"w{i}"] = w.to(device=device, dtype=dt)
        params[f"b{i}"] = torch.zeros((dout,), dtype=dt, device=device)
    return params


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device: "str | torch.device") -> Dict[str, torch.Tensor]:
    """Carry parameters made elsewhere (e.g. the JAX package's `gcn_init`,
    through `np.asarray`) onto `device`, values unchanged."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def gcn_forward(cfg: GCNConfig, params: Mapping[str, torch.Tensor], a,
                h0: torch.Tensor, engine: Optional[object] = None
                ) -> torch.Tensor:
    """`a`: dense tensor (in-core) or CSR (out-of-core with `engine`)."""
    n_layers = len([k for k in params if k.startswith("w")])
    h = h0
    for i in range(n_layers):
        if cfg.out_of_core and isinstance(a, CSR):
            if engine is None:
                raise ValueError("the out-of-core path needs an AiresSpGEMM")
            x = engine(a, h)                      # streamed Ã·H
        else:
            x = torch.matmul(a.to(torch.float32),
                             h.to(torch.float32)).to(h.dtype)
        w = params[f"w{i}"]
        # jnp promotes mixed operands (f32 X from the streamed SpMM against
        # 16-bit W gives f32); torch.matmul does not, so promote here.
        dt = torch.promote_types(x.dtype, w.dtype)
        h = x.to(dt) @ w.to(dt) + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def gcn_loss(cfg: GCNConfig, params, a, h0, labels: torch.Tensor,
             engine: Optional[object] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits against `labels`."""
    logits = gcn_forward(cfg, params, a, h0, engine).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)
