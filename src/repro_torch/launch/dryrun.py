"""Multi-pod dry run: trace every (arch × shape × mesh) cell at full size,
per device, without allocating anything, as `repro.launch.dryrun` lowers
and compiles it for 512 placeholder devices.

Per cell this:
  1. builds the full-size config and its stacked params, optimizer state
     and decode state on the meta device, and makes each leaf a DTensor of
     fake local shards on a production `DeviceMesh` over the "fake"
     process-group backend, placed by the sharding rules of
     `launch.sharding` (the reference's PartitionSpecs): no storage
     anywhere;
  2. traces the step (the train step, the prefill step or the serve step)
     with `torch.compile(fullgraph=True)` and a backend that only captures:
     AOTAutograd lowers the DTensor program to FX graphs of local shapes
     (forward and backward; the optimizer's update as a third graph), with
     every collective an explicit `_c10d_functional` call. Nothing is
     compiled or run beyond that. The train step ends in the reference's
     `out_shardings`: the loss replicated, params and optimizer state in
     their specs, so that the deferred reductions DTensor keeps as
     `Partial` are counted;
  3. reads the graphs (`_analyze`): argument, output, temporary and
     aliased bytes per device, FLOPs (`FlopCounterMode`'s formulas over the
     graphs' fake local values), bytes accessed and collective bytes
     (`launch.hlo_analysis`);
  4. traces one unit of the scan standalone (`_body_cost`) under the
     reference's keys, and writes everything to <out>/<cell>.json.
     `lower_s` holds the trace's seconds and `compile_s` the counts', in
     the reference's places for lowering and compiling.

A trace unrolls the port's Python loop over layers, so the step's own
figures already hold all R repeats of the unit: `total_*` is the step's
own count, not module + (R − 1) × body as XLA's count of a `while` body
needs. The body is there for the per-unit view. The sLSTM's loop over
time is not unrolled: a trace keeps it as one operator
(`torch.ops.repro_torch.slstm_scan`, its backward `slstm_scan_bwd`), whose
FLOP formulas count its products at every one of the S steps, as a walk
of the reference's jaxpr counts a `scan` body S times; its bytes are its
operands' and outputs', once.

A decode cell's caches lie on the ranks as `launch.sharding.state_pspecs`
places them, and each rank writes the token's K and V into its own shard
and attends over it (`transformer.LayerSlice`, `write_local`): only the
token's tensors, the attention scores of a head-dim-sharded cache and a
recurrent layer's state move, not the caches. The trace runs as rank 0
of the fake world.

The attention kernels are traced as their operators
(`torch.ops.repro_torch.flash_attn`, `flash_attn_bwd`, `decode_attn`, and
`decode_scores` with `decode_softmax_v` where a cache's head dim is
sharded):
their FLOP formulas are the reference's einsums' counts. On a machine with
a card the fake tensors lie on "cuda", elsewhere on "cpu"; the figures are
per-device planning numbers on the fake backend, not measurements.

A process takes one world, the "fake" process group of 512 ranks, made at
the first cell and kept: the single-pod mesh (16, 16) spans its ranks
0-255 and the two-pod mesh (2, 16, 16) all of them (`production_mesh`),
so that `--mesh both` runs both in one process. With `--jobs N` each
cell runs in a process of its own instead, N at once, its output in
OUT/<cell>.log.

Usage:
  python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/dryrun]
      [--jobs N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import SHAPES, arch_ids, get_config, shape_applicable
from repro_torch.launch.hlo_analysis import (
    graph_collective_bytes, graph_collective_count,
)
from repro_torch.launch.sharding import (
    P, batch_pspec, local_shape, opt_state_pspecs, placements, state_pspecs,
    tree_pspecs,
)
from repro_torch.launch.specs import input_specs
from repro_torch.models import transformer as T
from repro_torch.models.stacked import (
    _unit_apply, decode_step_scan, forward_scan, group_split,
    init_decode_state_stacked, init_params_stacked, lm_loss_scan, unit_kinds,
)
from repro_torch.models.transformer import MESH_AXES_MULTI, MESH_AXES_SINGLE
from repro_torch.train.optim import make_optimizer, tree_leaves, tree_map

ADAFACTOR_THRESHOLD = 100e9  # params above this use factored moments


def _mesh_axes(multi_pod: bool):
    return MESH_AXES_MULTI if multi_pod else MESH_AXES_SINGLE


def _param_count(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tensor_bytes(t) -> int:
    """A tensor's bytes (a DTensor's local shard's); 0 for anything
    else."""
    if not isinstance(t, torch.Tensor):
        return 0
    t = getattr(t, "_local_tensor", t)
    return int(t.numel()) * t.element_size()


def _nbytes(leaf) -> int:
    """An argument's or output's bytes: a tensor's, or 4 for a Python int,
    the port's step and position counters, which are the reference's 0-d
    int32 arrays."""
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return 4
    return _tensor_bytes(leaf)


# ------------------------------------------------------------ the inputs ----

def _map2(fn, tree, specs):
    """fn(leaf, spec) over a tree of dicts and lists and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def _fake_dtensors(tree, specs, mesh, device, requires_grad: bool = False):
    """Each meta leaf of `tree` as a DTensor on `mesh` whose local shard is
    a fake tensor on `device` of the shape its spec implies (call inside a
    `FakeTensorMode`); Python scalars (the step and position counters) as
    they are."""
    from torch.distributed.tensor import DTensor

    def make(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        local = torch.empty(local_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device=device)
        out = DTensor.from_local(local, mesh, list(placements(spec, mesh)),
                                 run_check=False)
        return out.requires_grad_(True) if requires_grad else out

    return _map2(make, tree, specs)


def _to_specs(tree, specs, mesh):
    """Each DTensor leaf redistributed to its spec (the reference's
    `out_shardings`)."""
    return _map2(lambda t, s: t.redistribute(mesh, list(placements(s, mesh)))
                 if isinstance(t, torch.Tensor) else t, tree, specs)


# ------------------------------------------------------------- the trace ----

class _Capture:
    """A `torch.compile` backend that keeps AOTAutograd's forward and
    backward graphs, with their fake example inputs, and runs them as they
    are (on fake tensors: shapes only)."""

    def __init__(self):
        self.graphs: List[tuple] = []

    def __call__(self, gm, example_inputs):
        from functorch.compile import aot_module_simplified, make_boxed_func

        def keep(label):
            def compiler(graph, inputs):
                self.graphs.append((label, graph, list(inputs)))
                return make_boxed_func(graph.forward)
            return compiler

        return aot_module_simplified(gm, example_inputs,
                                     fw_compiler=keep("forward"),
                                     bw_compiler=keep("backward"))


def _compile(fn, capture: _Capture):
    return torch.compile(fn, backend=capture, fullgraph=True, dynamic=False)


@contextlib.contextmanager
def _tracing(device: str):
    """Fake tensors, DTensor's implicit replication (the model's own plain
    tensors replicate beside the params, `transformer.on_mesh`) and a clean
    `torch.compile` cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    T.register_dtensor_rules()
    torch._dynamo.reset()
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding\
        .cache_clear()
    with FakeTensorMode(allow_non_fake_inputs=True), implicit_replication():
        yield
    torch._dynamo.reset()


# ------------------------------------------------------------ the counts ----

def _is_view(node) -> bool:
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return True                     # operator.getitem and the like
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns)


def _val_bytes(val) -> int:
    """The bytes of a node's value: a tensor, or a list or tuple of them."""
    if isinstance(val, (list, tuple)):
        return sum(_val_bytes(v) for v in val)
    return _tensor_bytes(val)


def _peak_live_bytes(gm, temp_inputs: bool, outputs_are_temps: bool) -> int:
    """The peak, in node order, of the bytes of live intermediate values:
    each from the node that makes it to its last user. Placeholders count
    where `temp_inputs` says (the backward's saved activations), never the
    step's own arguments (named `primals_*`/`arg*`); the graph's outputs
    stay live to its end where `outputs_are_temps` (a forward's saved
    activations), else they are the step's outputs and not counted."""
    nodes = list(gm.graph.nodes)
    order = {n: i for i, n in enumerate(nodes)}
    out_node = nodes[-1]
    outputs = {a for a in out_node.all_input_nodes}
    last = {}
    for n in nodes:
        for a in n.all_input_nodes:
            last[a] = order[n]
    size = {}
    for n in nodes:
        if n.op == "output":
            continue
        if n.op == "placeholder":
            if not temp_inputs or n.name.startswith(("primals", "arg")):
                continue
        elif n.op != "call_function" or _is_view(n):
            continue
        if n in outputs and not outputs_are_temps:
            continue
        size[n] = _val_bytes(n.meta.get("val"))
    live, peak = 0, 0
    ends: Dict[int, int] = {}
    for i, n in enumerate(nodes):
        if n in size:
            live += size[n]
            end = len(nodes) if n in outputs else last.get(n, i)
            ends[end] = ends.get(end, 0) + size[n]
        peak = max(peak, live)
        live -= ends.pop(i, 0)
    return peak


def _graph_bytes_accessed(gm) -> int:
    """Input plus output bytes of every node that makes a new value
    (collectives' waits and views excluded). Nothing is fused, so this is
    an upper bound on what XLA's fused `bytes accessed` counts."""
    total = 0
    for n in gm.graph.nodes:
        if n.op != "call_function" or _is_view(n) or \
                "wait_tensor" in str(n.target):
            continue
        total += _val_bytes(n.meta.get("val"))
        total += sum(_val_bytes(a.meta.get("val"))
                     for a in n.all_input_nodes)
    return total


def _graph_flops(graphs) -> int:
    """`FlopCounterMode`'s formulas over each captured graph's nodes, on
    their fake local values: per device. Matrix products count 2·m·n·k;
    the attention operators count their formulas."""
    from torch.utils.flop_counter import flop_registry
    total = 0
    for _, gm, _ in graphs:
        for n in gm.graph.nodes:
            formula = flop_registry.get(
                getattr(n.target, "overloadpacket", None))
            if n.op != "call_function" or formula is None:
                continue
            args, kwargs = torch.fx.node.map_arg(
                (n.args, n.kwargs), lambda a: a.meta.get("val"))
            total += formula(*args, **kwargs, out_val=n.meta.get("val"))
    return total


def _analyze(graphs, args, outputs, alias_bytes: int = 0
             ) -> Dict[str, Any]:
    """The reference's `_analyze` keys for the captured graphs of a step
    whose arguments and outputs are the trees `args` and `outputs` (of
    DTensors): argument and output bytes are their local shards' bytes,
    temp bytes `_peak_live_bytes` over the graphs (the forward's saved
    activations live into the backward), alias bytes the outputs that are
    arguments (a decode step's caches, written in place)."""
    temp = 0
    for label, gm, _ in graphs:
        temp = max(temp, _peak_live_bytes(
            gm, temp_inputs=label == "backward",
            outputs_are_temps=label == "forward" and any(
                lab == "backward" for lab, _, _ in graphs)))
    coll_total, by_kind, count = 0, {}, 0
    bytes_accessed = 0
    for _, gm, _ in graphs:
        t, kinds = graph_collective_bytes(gm)
        coll_total += t
        for k, v in kinds.items():
            by_kind[k] = by_kind.get(k, 0) + v
        count += graph_collective_count(gm)
        bytes_accessed += _graph_bytes_accessed(gm)
    return {
        "memory": {
            "argument_bytes": sum(_nbytes(t) for t in _leaves(args)),
            "output_bytes": sum(_nbytes(t) for t in _leaves(outputs)),
            "temp_bytes": int(temp),
            "alias_bytes": int(alias_bytes),
        },
        "cost": {
            "flops": float(_graph_flops(graphs)),
            "bytes_accessed": float(bytes_accessed),
        },
        "collectives": {"bytes": int(coll_total), "by_kind": by_kind,
                        "count": int(count)},
    }


def _alias_bytes(args, outputs) -> int:
    """Bytes of the output leaves that are argument leaves (the same
    tensors)."""
    ids = {id(t) for t in _leaves(args)}
    return sum(_nbytes(t) for t in _leaves(outputs) if id(t) in ids)


# ------------------------------------------------------------- the steps ----

def _train(cfg, mesh, mesh_axes, abs_params, params, param_specs, opt_name,
           batch, device) -> tuple:
    """Trace the train step: (graphs, args, outputs). Forward and backward
    of `lm_loss_scan`, the loss replicated; then the update, grads in,
    params and optimizer state out in their specs."""
    from torch.distributed.tensor import Replicate
    opt_init, opt_update = make_optimizer(opt_name, lr=1e-4)
    abs_opt = opt_init(abs_params)
    opt_specs = opt_state_pspecs(abs_opt, param_specs, mesh)
    opt_state = _fake_dtensors(abs_opt, opt_specs, mesh, device)
    capture = _Capture()

    def loss_fn(params, batch):
        loss = lm_loss_scan(cfg, params, batch["tokens"], batch["labels"],
                            vision_embeds=batch.get("vision_embeds"),
                            audio_embeds=batch.get("audio_embeds"),
                            mesh_axes=mesh_axes)
        return loss.redistribute(mesh, [Replicate()] * mesh.ndim)

    def update(params, grads, opt_state):
        new_params, new_opt = opt_update(params, grads, opt_state)
        return (_to_specs(new_params, param_specs, mesh),
                _to_specs(new_opt, opt_specs, mesh))

    loss = _compile(loss_fn, capture)(params, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    grads = tree_map(lambda _: next(grads), params)
    detached = tree_map(lambda p: p.detach(), params)
    update_capture = _Capture()
    with torch.no_grad():
        new_params, new_opt = _compile(update, update_capture)(
            detached, grads, opt_state)
    graphs = capture.graphs + [("update", gm, ins)
                               for _, gm, ins in update_capture.graphs]
    return graphs, (params, opt_state, batch), (loss, new_params, new_opt)


def cell_header(cfg, shape: Dict[str, Any], abs_params=None
                ) -> Dict[str, Any]:
    """The cell's plan before any trace: params (the full-size count),
    fsdp, scan_repeats and, for a train cell, the optimizer, by the
    reference's thresholds."""
    if abs_params is None:
        abs_params = init_params_stacked(cfg, None, device="meta")
    n_params = _param_count(abs_params)
    # FSDP only when bf16 params can't replicate across the data axis, as
    # in the reference; smaller models keep params TP-only + ZeRO-1.
    out = {"params": n_params, "fsdp": n_params > 30e9,
           "scan_repeats": group_split(cfg)[0]}
    if shape["kind"] == "train":
        out["optimizer"] = ("adafactor" if n_params > ADAFACTOR_THRESHOLD
                            else "adamw")
    return out


def dryrun_cell(cfg, shape: Dict[str, Any], mesh, mesh_axes,
                body_costs: bool = True) -> Dict[str, Any]:
    """One cell's trace and counts on `mesh` (a `DeviceMesh` over a "fake"
    process group the caller made): `run_cell`'s work, and the tests' way
    to reach a SMOKE config on a small mesh. Returns the reference's keys
    from "params" on (the caller adds arch, shape, mesh, kind, ok); raises
    where the trace fails."""
    kind = shape["kind"]
    device = mesh.device_type
    abs_params = init_params_stacked(cfg, None, device="meta")
    result = cell_header(cfg, shape, abs_params)
    fsdp = result["fsdp"]
    param_specs = tree_pspecs(abs_params, mesh, fsdp=fsdp)
    specs = input_specs(cfg, shape)

    t_l = time.time()
    with _tracing(device):
        params = _fake_dtensors(abs_params, param_specs, mesh, device,
                                requires_grad=kind == "train")
        batch_specs = {k: batch_pspec(v.shape, mesh)
                       for k, v in specs.items()}
        batch = _fake_dtensors(specs, batch_specs, mesh, device)
        alias = 0
        if kind == "train":
            graphs, args, outputs = _train(
                cfg, mesh, mesh_axes, abs_params, params, param_specs,
                result["optimizer"], batch, device)
        elif kind == "prefill":
            capture = _Capture()

            def prefill_step(params, batch):
                logits, _ = forward_scan(
                    cfg, params, batch["tokens"],
                    vision_embeds=batch.get("vision_embeds"),
                    audio_embeds=batch.get("audio_embeds"),
                    mesh_axes=mesh_axes, last_only=True)
                return logits

            with torch.no_grad():
                logits = _compile(prefill_step, capture)(params, batch)
            graphs, args, outputs = capture.graphs, (params, batch), logits
        else:
            abs_state = init_decode_state_stacked(
                cfg, shape["global_batch"], shape["seq_len"], device="meta")
            state = _fake_dtensors(abs_state, state_pspecs(abs_state, mesh),
                                   mesh, device)
            capture = _Capture()

            def serve_step(params, token, state, enc_out=None):
                return decode_step_scan(cfg, params, token, state,
                                        enc_out=enc_out, mesh_axes=mesh_axes)

            with torch.no_grad():
                outputs = _compile(serve_step, capture)(
                    params, batch["token"], state, batch.get("enc_out"))
            graphs = capture.graphs
            args = (params, batch, state)
            alias = _alias_bytes(state, outputs)
        result["lower_s"] = round(time.time() - t_l, 2)
        t_c = time.time()
        result.update(_analyze(graphs, args, outputs, alias))
        result["compile_s"] = round(time.time() - t_c, 2)

    if body_costs:
        abs_state = (init_decode_state_stacked(
            cfg, shape["global_batch"], shape["seq_len"], device="meta")
            if kind == "decode" else None)
        body = _body_cost(cfg, mesh, mesh_axes, shape, kind, abs_params,
                          abs_state, fsdp=fsdp)
        result["body"] = body
        # The trace unrolls every repeat: the step's own figures are the
        # totals (see the module docstring).
        result["total_flops"] = result["cost"]["flops"]
        result["total_bytes_accessed"] = result["cost"]["bytes_accessed"]
        result["total_collective_bytes"] = result["collectives"]["bytes"]
    return result


def _body_cost(cfg, mesh, mesh_axes, shape, kind: str, abs_params,
               abs_state=None, fsdp: bool = False) -> Dict[str, Any]:
    """Trace one scan unit standalone → per-iteration cost/collectives."""
    u_kinds = unit_kinds(cfg)
    device = mesh.device_type
    b = shape["global_batch"]
    s = shape["seq_len"] if kind != "decode" else 1
    act_dt = getattr(torch, cfg.dtype)

    abs_unit = [tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype,
                                               device="meta"), g)
                for g in abs_params["scan"]]
    unit_specs = [tree_pspecs(u, mesh, fsdp=fsdp) for u in abs_unit]
    x_meta = torch.empty((b, s, cfg.d_model), dtype=act_dt, device="meta")
    # Activations are replicated across the model axis between blocks, as
    # the reference's probe takes them.
    x_spec = P(batch_pspec((b, s, cfg.d_model), mesh)[0], None, None)
    if cfg.mrope_sections is not None:
        pos_meta = torch.empty((3, b, shape["seq_len"]), dtype=torch.int32,
                               device="meta")
        pos_spec = P(None, batch_pspec((b,), mesh)[0], None)
    else:
        pos_meta = torch.empty((b, s), dtype=torch.int32, device="meta")
        pos_spec = batch_pspec((b, s), mesh)
    enc_meta = enc_spec = None
    if cfg.is_enc_dec and kind != "decode":
        enc_meta = torch.empty((b, cfg.audio_frames, cfg.d_model),
                               dtype=act_dt, device="meta")
        enc_spec = batch_pspec(enc_meta.shape, mesh)

    capture = _Capture()
    with _tracing(device):
        unit = _fake_dtensors(abs_unit, unit_specs, mesh, device,
                              requires_grad=kind == "train")
        enc_out = (None if enc_meta is None else
                   _fake_dtensors(enc_meta, enc_spec, mesh, device))
        if kind in ("train", "prefill"):
            x = _fake_dtensors(x_meta, x_spec, mesh, device,
                               requires_grad=kind == "train")
            positions = _fake_dtensors(pos_meta, pos_spec, mesh, device)

            def body(x, unit, positions, enc_out):
                return _unit_apply(cfg, u_kinds, unit, x, positions,
                                   mesh_axes, enc_out)[0]

            if kind == "train":
                ct = _fake_dtensors(x_meta, x_spec, mesh, device)
                y = _compile(body, capture)(x, unit, positions, enc_out)
                grads = torch.autograd.grad(y, [x, *tree_leaves(unit)], ct)
                args, outputs = (x, ct, positions, unit, enc_out), \
                    (y, grads)
            else:
                with torch.no_grad():
                    y = _compile(body, capture)(x, unit, positions, enc_out)
                args, outputs = (x, positions, unit, enc_out), y
            alias = 0
        else:   # decode: one unit step against a stacked-state slice
            abs_unit_state = [tree_map(
                lambda t: torch.empty(t.shape[1:], dtype=t.dtype,
                                      device="meta"), g)
                for g in abs_state["scan"]]
            states = [_fake_dtensors(st, state_pspecs(st, mesh), mesh,
                                     device) for st in abs_unit_state]
            x1_meta = torch.empty((b, 1, cfg.d_model), dtype=act_dt,
                                  device="meta")
            x1 = _fake_dtensors(x1_meta, P(batch_pspec((b,), mesh)[0], None,
                                           None), mesh, device)

            def body(x, unit, states):
                new_states = []
                for j, k_ in enumerate(u_kinds):
                    x, ns = _decode_apply_one(cfg, k_, unit[j], states[j], x,
                                              0)
                    new_states.append(ns)
                return x, new_states

            with torch.no_grad():
                outputs = _compile(body, capture)(x1, unit, states)
            args = (x1, unit, states)
            alias = _alias_bytes(states, outputs)
        return _analyze(capture.graphs, args, outputs, alias)


def _decode_apply_one(cfg, kind, p, st, x, pos: int):
    """Single-layer decode application shared with decode_step_scan
    (`transformer.decode_layer`) at position `pos`."""
    posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    return T.decode_layer(cfg, kind, p, st, x, pos, posb, {})


WORLD = 512      # ranks of the fake world: two pods of 16 × 16


@contextlib.contextmanager
def fake_world(world: int):
    """The "fake" process group of `world` ranks (this process is rank 0),
    destroyed on the way out. A trace with a backward after another world
    of the same process has traced fails in AOTAutograd's partitioner
    (torch 2.11-2.13), so a process takes one world: `run_cell` makes one
    of WORLD ranks at its first cell and keeps it (`production_mesh`)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool, device_type: str):
    """`launch.mesh.make_production_mesh`'s mesh over ranks 0-255 (one pod)
    or 0-511 (two) of this process's fake world of WORLD ranks, made at the
    first call and kept: the dry run's counterpart of the reference's 512
    placeholder devices, both meshes in one world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    if dist.get_world_size() < ranks.numel():
        raise RuntimeError(f"the process group has {dist.get_world_size()} "
                           f"ranks, the mesh {shape} needs {ranks.numel()}")
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             body_costs: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_axes = _mesh_axes(multi_pod)
    kind = shape["kind"]
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": kind, "ok": False,
    }

    runs, reason = shape_applicable(arch, shape_name)
    if not runs:
        result["skipped"] = reason
        return result

    t0 = time.time()
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        mesh = production_mesh(multi_pod, device_type)
        result.update(dryrun_cell(cfg, shape, mesh, mesh_axes, body_costs))
        print(json.dumps({k: result[k] for k in ("memory", "cost")}))
        result["ok"] = True
    except Exception as err:  # noqa: BLE001
        result["error"] = f"{type(err).__name__}: {err}"
        result["traceback"] = traceback.format_exc()[-2000:]
    result["elapsed_s"] = round(time.time() - t0, 2)
    return result


def _status(res: Dict[str, Any]) -> str:
    return ("OK" if res.get("ok")
            else ("SKIP: " + res["skipped"]) if "skipped" in res
            else "FAIL: " + res.get("error", "?"))


def _run_jobs(cells: list, args) -> None:
    """Each cell in a process of its own (this module with --force), at
    most `args.jobs` at once, its output in OUT/<cell>.log; `[run ]` as
    each starts and `[done]` as each ends, from its JSON."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    pending, running = list(cells), []
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape, mp, name, path = pending.pop(0)
            log = open(os.path.join(args.out, name + ".log"), "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh",
                   "multi" if mp else "single", "--out", args.out,
                   "--force"] + (["--no-body"] if args.no_body else [])
            print(f"[run ] {name}", flush=True)
            running.append((name, path, log, time.time(), subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT)))
        time.sleep(0.5)
        for item in [r for r in running if r[4].poll() is not None]:
            name, path, log, t0, proc = item
            log.close()
            running.remove(item)
            res = (json.load(open(path)) if os.path.exists(path) else
                   {"error": f"no result (exit {proc.returncode}; see "
                             f"{name}.log)"})
            print(f"[done] {name}: {_status(res)} "
                  f"({round(time.time() - t0, 1)}s)", flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-body", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=0,
                    help="run each cell in a process of its own, this many "
                         "at once (0: every cell in this process)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = arch_ids() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, name + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {name} (exists)")
                    continue
                cells.append((arch, shape, mp, name, path))
    if args.jobs > 0:
        _run_jobs(cells, args)
        return

    for arch, shape, mp, name, path in cells:
        print(f"[run ] {name}", flush=True)
        res = run_cell(arch, shape, mp, body_costs=not args.no_body)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"[done] {name}: {_status(res)} ({res.get('elapsed_s', 0)}s)",
              flush=True)


if __name__ == "__main__":
    main()
