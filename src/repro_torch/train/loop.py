"""Out-of-core GCN training: the GCN half of `repro.train.loop`.

`make_gcn_train_step` / `gcn_train_loop` drive the paper's workload:
gradients flow through `AiresSpGEMM`'s autograd Function, so every
optimizer step really streams A forward and Aᵀ backward. The LM half
(`make_train_step`, `train_loop`, `TrainLoopConfig`) is not ported yet.
"""
from __future__ import annotations

import time

import torch

from repro_torch.models.gcn import gcn_loss
from repro_torch.train.optim import make_optimizer


def make_gcn_train_step(cfg, engine, a, h0, labels,
                        optimizer: str = "adamw", lr: float = 1e-2,
                        **opt_kwargs):
    """Out-of-core GCN train step.

    cfg is a `repro_torch.models.gcn.GCNConfig` with out_of_core=True,
    `engine` an `AiresSpGEMM`, `a` a host CSR. Returns (init_opt, step)
    with step(params, opt_state) -> (loss, params, opt_state); params are
    dicts of tensors, and the returned ones do not require grad.
    """
    init_opt, opt_update = make_optimizer(optimizer, lr=lr, **opt_kwargs)

    def step(params, opt_state):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = gcn_loss(cfg, leaves, a, h0, labels, engine=engine)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params, opt_state = opt_update(params, dict(zip(leaves, grads)),
                                       opt_state)
        return loss.detach(), params, opt_state

    return init_opt, step


def gcn_train_loop(cfg, engine, a, h0, labels, params, n_epochs: int,
                   optimizer: str = "adamw", lr: float = 1e-2,
                   log_every: int = 1):
    """Drive true out-of-core GCN epochs; returns (params, info).

    info carries the loss history [(epoch, loss)], the per-epoch forward
    and backward `StreamStats` logs from the engine (backward in layer
    order, as the reference reports it) and the wall seconds, read after
    the engine's device has finished.
    """
    init_opt, step = make_gcn_train_step(cfg, engine, a, h0, labels,
                                         optimizer=optimizer, lr=lr)
    opt_state = init_opt(params)
    history = []
    epochs = []
    t0 = time.perf_counter()
    for epoch in range(n_epochs):
        engine.reset_stats_logs()
        loss, params, opt_state = step(params, opt_state)
        epochs.append({
            "forward_stream": list(engine.forward_stats_log),
            "backward_stream": list(reversed(engine.backward_stats_log)),
        })
        if epoch % log_every == 0:
            history.append((epoch, float(loss)))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return params, {"history": history, "epochs": epochs,
                    "seconds": time.perf_counter() - t0}
