"""Expert-parallel MoE dispatch with explicit all-to-all over a named
`torch.distributed` DeviceMesh: the port of `repro.models.moe_shard_map`.

Every rank of the mesh's process group runs `moe_ffn_shard_map` on its own
shard, as the reference's `shard_map` cuts the operands:

  1. tokens are split over the data axes and replicated over the model
     axis; experts are partitioned over the model axis (E_loc = E / |model|
     per rank, model index r holding experts [r·E_loc, (r+1)·E_loc)); the
     router is replicated;
  2. each rank routes its tokens and ranks each (token, slot) assignment
     within its destination rank with the same stable argsort and
     histogram, keeping `cap` per destination;
  3. one all-to-all over the model axis delivers each rank the tokens for
     its experts (with their local expert ids and valid flags); the local
     experts run; a second all-to-all returns the outputs;
  4. each token combines its k outputs with the saved top-k weights.

The reference gathers each received row's expert weights (`wg[reid]`, a
(|model|·cap, d, f) intermediate, gigabytes at real widths); here the rows
are grouped by local expert and each expert runs one product, the same
function without that intermediate.

Gradients: the exchange's backward is the reverse all-to-all and the aux
mean's is the mean of its gradient, as JAX differentiates `shard_map`
through `all_to_all` and `pmean`. With a loss summed over ranks that
counts each output shard once (each rank of a model group weighting its
copy by 1/|model|), each rank's gradients are its replica's share: a
replicated operand's gradient is the sum over its replicas (the banks'
over the data axes, the router's over the mesh).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import matmul


def _rank_in_group(group_ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Rank of each element within its group (histogram + sorted order)."""
    n = group_ids.shape[0]
    order = torch.argsort(group_ids, stable=True)
    hist = torch.bincount(group_ids, minlength=n_groups)
    starts = torch.cumsum(hist, 0) - hist
    ranks_sorted = torch.arange(n, device=group_ids.device) \
        - starts[group_ids[order]]
    ranks = torch.empty_like(ranks_sorted)
    ranks[order] = ranks_sorted
    return ranks


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single over `group` in equal chunks of dim 0: chunk i
    goes to group rank i, and chunk i of the result came from it."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over `group` (the reference's `pmean`)."""
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


class _SelfAdjoint(torch.autograd.Function):
    """A collective that is its own adjoint, under autograd: the forward
    applies `op` over `group`, the backward applies it to the gradient.
    `_exchange`'s backward so returns each chunk's gradient to the rank
    that sent it, and `_mean`'s averages the gradient over the group."""

    @staticmethod
    def forward(ctx, x, op, group):
        ctx.op, ctx.group = op, group
        return op(x, group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.op(grad, ctx.group), None, None


def _local_experts(p: Dict[str, torch.Tensor], rows: torch.Tensor,
                   eid: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each valid row through its local expert's SwiGLU, one product per
    expert over its rows (in arrival order); invalid rows give 0."""
    e_loc = p["w_gate"].shape[0]
    key = torch.where(valid, eid, torch.full_like(eid, e_loc))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=e_loc + 1).tolist()
    grouped = rows[order]
    outs, start = [], 0
    for j in range(e_loc):
        r = grouped[start:start + counts[j]]
        start += counts[j]
        if r.shape[0]:
            h = F.silu(matmul(r, p["w_gate"][j])) * matmul(r, p["w_up"][j])
            outs.append(matmul(h, p["w_down"][j]))
    out = rows.new_zeros(rows.shape)
    if not outs:
        return out
    return out.index_copy(0, order[:start], torch.cat(outs).to(rows.dtype))


def _local_moe(cfg: ArchConfig, p: Dict[str, torch.Tensor],
               xf: torch.Tensor, group, n_ranks: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's body: xf (t_loc, d) local tokens, p the local experts
    and the replicated router; (out (t_loc, d), this rank's aux)."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // n_ranks
    dev = xf.device

    probs = torch.softmax(matmul(xf, p["w_router"]).float(), dim=-1)
    # Ties to the lower expert, as `lax.top_k` (and `moe_ffn`) break them.
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    flat_e = top_e.reshape(-1)                                   # (t·k,)
    flat_w = top_p.reshape(-1)
    me = probs.mean(dim=0)
    ce = torch.bincount(flat_e, minlength=e).float() / t
    aux = e * torch.sum(me * ce) / k

    tok_id = torch.arange(t, device=dev).repeat_interleave(k)
    dest = flat_e // e_loc                                       # model rank
    # Capacity per destination rank: the tokens' assignments spread over
    # the ranks, rounded up to 8.
    cap = max(1, int(cfg.capacity_factor * t * k / n_ranks))
    cap = ((cap + 7) // 8) * 8
    n_slots = n_ranks * cap
    pos = _rank_in_group(dest, n_ranks)
    keep = pos < cap
    slot = torch.where(keep, dest * cap + pos, torch.full_like(pos, n_slots))

    # Each slot's token (t: the zero row) and (local expert, valid); the
    # dropped assignments go to the pad slot n_slots, which is not sent.
    token_for_slot = torch.full((n_slots + 1,), t, dtype=torch.long,
                                device=dev)
    token_for_slot[slot] = tok_id
    meta = torch.zeros((n_slots + 1, 2), dtype=torch.int32, device=dev)
    meta[slot, 0] = (flat_e % e_loc).to(torch.int32)
    meta[slot, 1] = keep.to(torch.int32)
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    send_x = xf_pad[token_for_slot[:n_slots]]

    # Exchange: this rank receives, from every peer, tokens for its experts.
    recv_x = _SelfAdjoint.apply(send_x, _exchange, group)
    recv_meta = _exchange(meta[:n_slots], group)
    out_tok = _local_experts(p, recv_x, recv_meta[:, 0].long(),
                             recv_meta[:, 1].bool()).to(xf.dtype)

    # Return the outputs to their senders; combine in slot order.
    back = _SelfAdjoint.apply(out_tok, _exchange, group)
    back = torch.cat([back, back.new_zeros((1, d))], dim=0)
    gathered = back[slot] * (flat_w * keep)[:, None].to(xf.dtype)
    gathered = gathered.reshape(t, k, d)
    out = gathered[:, 0]
    for j in range(1, k):                # the reference's order of adds
        out = out + gathered[:, j]
    return out, aux


def moe_ffn_shard_map(cfg: ArchConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, mesh, data_axes: Sequence[str],
                      model_axis: str = "model"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (out, aux): x (B_loc, S, D) is the rank's shard of the
    batch over `data_axes` (the same on every rank of its model group);
    p["w_gate"], p["w_up"] (E_loc, d, f) and p["w_down"] (E_loc, f, d) are
    its model index's experts, p["w_router"] (d, E) whole. out is the
    shard's output; aux the router's load-balancing loss averaged over the
    model axis, then over each data axis (the reference's `pmean`s). Runs
    on the mesh's device type (CUDA with NCCL on the card); raises where
    E does not divide the model axis or the operands do not match it."""
    names = tuple(mesh.mesh_dim_names)
    n_ranks = mesh.size(names.index(model_axis))
    e = cfg.n_experts
    if e % n_ranks:
        raise ValueError(f"E = {e} must divide the model axis "
                         f"({n_ranks} ranks); use layers.moe_ffn otherwise")
    e_loc = e // n_ranks
    for name in ("w_gate", "w_up", "w_down"):
        if p[name].shape[0] != e_loc:
            raise ValueError(f"{name} holds {p[name].shape[0]} experts, "
                             f"the rank's shard is {e_loc}")
    if x.device.type != mesh.device_type:
        raise ValueError(f"x lies on {x.device}, the mesh on "
                         f"{mesh.device_type}")
    group = mesh.get_group(model_axis)
    out, aux = _local_moe(cfg, p, x.reshape(-1, x.shape[-1]), group,
                          n_ranks)
    aux = _SelfAdjoint.apply(aux, _mean, group)
    for ax in data_axes:
        aux = _SelfAdjoint.apply(aux, _mean, mesh.get_group(ax))
    return out.reshape(x.shape), aux
