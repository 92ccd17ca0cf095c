"""The LM train step and its resumable training loop, and the
out-of-core GCN train loop: the port of `repro.train.loop`.

`make_train_step` returns a (params, opt_state, batch, ef) → (loss,
params, opt_state, ef) step with optional gradient accumulation and int8
error-feedback gradient compression. Gradients flow through `lm_loss`, so
every attention launches the flash kernel forward and its hand-written
backward kernel (`kernels.flash_attn.FlashAttention`). The step runs
eagerly: `jax.jit` has no counterpart here.

`train_loop` drives steps and checkpoints every `checkpoint_every` steps
through `repro_torch.checkpoint`, resumable from `start_step`. With
`mesh_axes` the loss takes the sharding hints, and the params, optimizer
state and batch are DTensors on one `DeviceMesh` (`launch.sharding`): the
gradients reduce where DTensor places the reduction, and the int8
compression's scale is the max over the whole logical gradient, as the
reference's is under GSPMD. Without a mesh the compressed gradients are
quantized and dequantized in place of the reduce.

`make_gcn_train_step` / `gcn_train_loop` drive the paper's workload:
gradients flow through `AiresSpGEMM`'s autograd Function, so every
optimizer step really streams A forward and Aᵀ backward.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.gcn import gcn_loss
from repro_torch.models.transformer import lm_loss, on_mesh
from repro_torch.train.compression import (
    compress_grads, decompress_grads, ef_init,
)
from repro_torch.train.optim import make_optimizer, tree_leaves, tree_map


@dataclasses.dataclass
class TrainLoopConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    grad_accum: int = 1
    compress: bool = False         # int8 EF gradient compression
    checkpoint_every: int = 50
    max_steps: int = 200
    mesh_axes: Optional[bool] = None


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def make_train_step(cfg: ArchConfig, loop_cfg: TrainLoopConfig,
                    loss_fn: Optional[Callable] = None):
    """The step(params, opt_state, batch, ef=None) → (loss, params,
    opt_state, ef) of `repro.train.loop.make_train_step`.

    `batch` holds "tokens" and "labels" (numpy arrays or tensors, moved to
    the params' device), shaped (B, S), or (grad_accum, B, S) when
    `grad_accum` > 1: then the microbatch losses and gradients are summed
    in f32 (in place, one accumulator per parameter) and divided by
    `grad_accum`. With `compress` and an `ef` tree the gradients go through
    `compress_grads` and `decompress_grads` before the update. The loss is
    a detached 0-d f32 tensor; the params returned do not require grad.
    `loop_cfg.mesh_axes` goes to `lm_loss`: its hints need DTensor params
    and batch, and raise on plain tensors, as the reference's do outside a
    mesh.
    """
    loss_fn = loss_fn or (
        lambda params, batch: lm_loss(
            cfg, params, batch["tokens"], batch["labels"],
            vision_embeds=batch.get("vision_embeds"),
            audio_embeds=batch.get("audio_embeds"),
            mesh_axes=loop_cfg.mesh_axes))
    _, opt_update = make_optimizer(loop_cfg.optimizer, lr=loop_cfg.lr)

    def micro_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss = loss_fn(live, batch)
            # A leaf the loss does not reach (Qwen2-VL's vision_proj on a
            # batch without vision input) gets zeros, as jax.grad gives.
            grads = iter([torch.zeros_like(p) if g is None else g
                          for p, g in zip(leaves, torch.autograd.grad(
                              loss, leaves, allow_unused=True))])
        return loss.detach(), tree_map(lambda _: next(grads), params)

    @on_mesh
    def train_step(params, opt_state, batch, ef=None):
        device = _device_of(params)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items() if v is not None}
        if loop_cfg.grad_accum > 1:
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(loop_cfg.grad_accum):
                micro_loss, micro = micro_grads(
                    params, {k: v[i] for k, v in batch.items()})
                loss = loss + micro_loss
                tree_map(lambda acc, g: acc.add_(g), grads, micro)
                del micro
            loss = loss / loop_cfg.grad_accum
            grads = tree_map(lambda g: g.div_(loop_cfg.grad_accum), grads)
        else:
            loss, grads = micro_grads(params, batch)

        new_ef = ef
        if loop_cfg.compress and ef is not None:
            q, scales, new_ef = compress_grads(grads, ef)
            del grads
            grads = decompress_grads(q, scales)
            del q

        params, opt_state = opt_update(params, grads, opt_state)
        return loss, params, opt_state, new_ef

    return train_step


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


def train_loop(cfg: ArchConfig, loop_cfg: TrainLoopConfig, params, opt_state,
               batches, checkpointer=None, start_step: int = 0,
               log_every: int = 10, ef=None):
    """Checkpoint every `checkpoint_every` steps (after the step's update,
    at steps > 0), resumable from `start_step`; returns (params, opt_state,
    info) with info {"history": [(step, loss)], "seconds", "ef"}, the
    seconds read after the params' device has finished."""
    step_fn = make_train_step(cfg, loop_cfg)
    if loop_cfg.compress and ef is None:
        ef = ef_init(params)
    history = []
    t0 = time.perf_counter()
    for step, batch in enumerate(batches, start=start_step):
        if step >= loop_cfg.max_steps:
            break
        loss, params, opt_state, ef = step_fn(params, opt_state, batch, ef)
        if step % log_every == 0:
            history.append((step, float(loss)))
        if checkpointer is not None and step and \
                step % loop_cfg.checkpoint_every == 0:
            checkpointer.save(step, params, opt_state, ef=ef)
    device = _device_of(params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    return params, opt_state, {"history": history, "seconds": elapsed,
                               "ef": ef}
