"""`launch.dryrun` against `repro.launch.dryrun`.

  * Every arch × shape: the cell's plan (params, fsdp, optimizer,
    scan_repeats) and its skip equal the reference's, from `jax.eval_shape`
    of its `init_params_stacked`, its thresholds and `shape_applicable`
    (a subprocess: importing `repro.launch.dryrun` sets XLA_FLAGS).
  * The same subprocess runs the reference's `run_cell` on SMOKE configs
    at small shapes on 8 of its host devices ((2, 4), GSPMD's Auto axes);
    the port's cell has the same keys, at every level.
  * On a (2, 4) mesh over the "fake" process group, SMOKE configs at small
    shapes: the per-device argument and output bytes are exactly the sums
    of each leaf's local shard bytes under the reference's own
    `tree_pspecs`, `opt_state_pspecs`, `batch_pspec` and `state_pspecs`.
    The port's traces run in two subprocesses of their own, each one fake
    world of 8 ranks (`dryrun.fake_world` says why), beside the
    reference's.
  * On a 1 × 1 mesh, the train and prefill steps of the dense (Yi-6B),
    Gemma-2, Mixtral, xLSTM-125M and Qwen2-VL-72B SMOKE configs (the last
    with its vision embeddings): `cost.flops` equals, to relative
    FLOPS_RTOL, the reference's matrix-product FLOPs, counted by walking
    the jaxpr of its step (`dot_general` at 2·m·n·k times its batch, times
    the enclosing `scan` lengths). The attention operators count the
    reference's einsums (`kernels.flash_attn`'s FLOP formulas) and the
    sLSTM's loop operator its products at every time step
    (`models.recurrent`'s), so no op is left out for these archs.
"""
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as r_configs
from repro.kernels.compat import make_abstract_mesh
from repro.launch import sharding as r_sh
from repro.models import stacked as r_st
from repro.train.optim import make_optimizer as r_make_optimizer
from repro_torch.configs import SHAPES, arch_ids, get_config
from repro_torch.launch import dryrun as D

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLOPS_RTOL = 1e-9
SMALL = {"train": dict(kind="train", seq_len=32, global_batch=8),
         "prefill": dict(kind="prefill", seq_len=32, global_batch=8),
         "decode": dict(kind="decode", seq_len=64, global_batch=8)}

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, functools
    import repro.launch.dryrun as dr
    from repro.configs import SHAPES, arch_ids, get_config, shape_applicable
    from repro.models.stacked import group_split, init_params_stacked

    small = json.loads(sys.argv[1])
    plans = {}
    for arch in arch_ids():
        cfg = get_config(arch)
        n = dr._param_count(jax.eval_shape(
            functools.partial(init_params_stacked, cfg),
            jax.random.PRNGKey(0)))
        for shape, spec in SHAPES.items():
            runs, reason = shape_applicable(arch, shape)
            plan = {"params": n, "fsdp": n > 30e9,
                    "scan_repeats": group_split(cfg)[0]}
            if spec["kind"] == "train":
                plan["optimizer"] = ("adafactor" if n > dr.ADAFACTOR_THRESHOLD
                                     else "adamw")
            plans[f"{arch}/{shape}"] = plan if runs else {"skipped": reason}

    # run_cell on SMOKE configs at small shapes on 8 of the host devices.
    dr.get_config = lambda arch: get_config(arch, smoke=True)
    dr.SHAPES = small
    dr.make_production_mesh = lambda multi_pod: jax.make_mesh(
        (2, 4), ("data", "model"), devices=jax.devices()[:8],
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cells = {kind: dr.run_cell("yi_6b", kind, False) for kind in small}
    print(json.dumps({"plans": plans, "cells": cells}))
""")


def _keys(d, prefix=""):
    """Every key path of a nested dict ("body/memory/temp_bytes")."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "by_kind":
            out |= _keys(v, f"{prefix}{k}/")
    return out


FLOPS_ARCHS = ("yi_6b", "gemma2_27b", "mixtral_8x22b", "xlstm_125m",
               "qwen2_vl_72b")

_PORT = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.transformer import MESH_AXES_SINGLE

    small, part = json.loads(sys.argv[1]), sys.argv[2]
    FLOPS_ARCHS = json.loads(sys.argv[3])
    out = {}
    with D.fake_world(8):
        if part == "small":
            mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                              mesh_dim_names=("data", "model"))
            cfg = get_config("yi_6b", smoke=True)
            for kind, shape in small.items():
                out[kind] = D.dryrun_cell(cfg, shape, mesh, MESH_AXES_SINGLE,
                                          body_costs=kind == "train")
        else:
            one = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.long),
                             mesh_dim_names=("data", "model"))
            for arch in FLOPS_ARCHS:
                for kind in ("train", "prefill"):
                    out[f"{arch}/{kind}"] = D.dryrun_cell(
                        get_config(arch, smoke=True), small[kind], one,
                        MESH_AXES_SINGLE, body_costs=False)["cost"]["flops"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs():
    """The reference's subprocess and the port's two (its small cells,
    its FLOPs cells), side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               json.dumps(SMALL), *part], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for code, part in ((_REFERENCE, ()),
                                (_PORT, ("small", json.dumps(FLOPS_ARCHS))),
                                (_PORT, ("flops", json.dumps(FLOPS_ARCHS))))]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def small_cells(runs):
    """The port's Yi-6B SMOKE cells on a (2, 4) fake mesh, every kind, the
    train cell with its body."""
    return runs[1]


def test_every_cell_plans_as_the_reference(reference):
    for arch in arch_ids():
        cfg = get_config(arch)
        for shape, spec in SHAPES.items():
            want = reference["plans"][f"{arch}/{shape}"]
            if "skipped" in want:
                got = D.run_cell(arch, shape, False)
                assert (got["ok"], got["skipped"]) == (False,
                                                       want["skipped"])
            else:
                assert D.cell_header(cfg, spec) == want, (arch, shape)


def test_cells_have_the_reference_keys(reference, small_cells):
    for kind, want in reference["cells"].items():
        assert want["ok"], want.get("error")
        got = {"arch": "yi_6b", "shape": kind, "mesh": "16x16",
               "kind": kind, "ok": True, "elapsed_s": 0.0,
               **small_cells[kind]}
        want_keys = _keys(want)
        if kind != "train":            # the port's small cells: body once
            want_keys = {k for k in want_keys
                         if not k.startswith(("body", "total_"))}
        assert _keys(got) == want_keys, kind


def _local_bytes(shape, dtype, spec, sizes) -> int:
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = entry if isinstance(entry, tuple) else (entry,)
        div = math.prod(sizes[a] for a in names if a is not None)
        n *= dim // div
    return n * np.dtype(dtype).itemsize


def _tree_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_local_bytes(x.shape, x.dtype, s, sizes)
               for x, s in zip(leaves, spec_leaves))


def test_argument_and_output_bytes_are_the_reference_specs(small_cells):
    cfg = r_configs.get_config("yi_6b", smoke=True)
    mesh = make_abstract_mesh((2, 4), ("data", "model"))
    sizes = {"data": 2, "model": 4}
    params = jax.eval_shape(functools.partial(r_st.init_params_stacked, cfg),
                            jax.random.PRNGKey(0))
    p_bytes = _tree_bytes(params, r_sh.tree_pspecs(params, mesh), sizes)
    opt = jax.eval_shape(r_make_optimizer("adamw", lr=1e-4)[0], params)
    o_bytes = _tree_bytes(opt, r_sh.opt_state_pspecs(
        opt, r_sh.tree_pspecs(params, mesh), mesh), sizes)

    def batch_bytes(kind):
        from repro.launch.specs import input_specs
        specs = input_specs(cfg, SMALL[kind])
        return sum(_local_bytes(v.shape, v.dtype,
                                r_sh.batch_pspec(v.shape, mesh), sizes)
                   for v in specs.values())

    train = small_cells["train"]["memory"]
    assert train["argument_bytes"] == p_bytes + o_bytes + batch_bytes("train")
    assert train["output_bytes"] == 4 + p_bytes + o_bytes   # f32 loss first
    b = SMALL["prefill"]["global_batch"]
    logits = _local_bytes((b, 1, cfg.vocab), jnp.float32,
                          jax.sharding.PartitionSpec("data", None, "model"),
                          sizes)
    prefill = small_cells["prefill"]["memory"]
    assert prefill["argument_bytes"] == p_bytes + batch_bytes("prefill")
    assert prefill["output_bytes"] == logits
    state = jax.eval_shape(functools.partial(
        r_st.init_decode_state_stacked, cfg, b, SMALL["decode"]["seq_len"]))
    s_bytes = _tree_bytes(state, r_sh.state_pspecs(state, mesh), sizes)
    decode = small_cells["decode"]["memory"]
    assert decode["argument_bytes"] == p_bytes + batch_bytes("decode") + \
        s_bytes
    assert decode["output_bytes"] == logits + s_bytes
    assert decode["alias_bytes"] == s_bytes - 4     # the caches; pos is new


def _dot_flops(jaxpr, mult=1) -> int:
    """2·m·n·k per `dot_general` (m, n its free sizes, k its contracted,
    times its batch), recursively, times each enclosing `scan`'s length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            ls, rs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            free_l = math.prod(d for i, d in enumerate(ls)
                               if i not in lc and i not in lb)
            free_r = math.prod(d for i, d in enumerate(rs)
                               if i not in rc and i not in rb)
            total += 2 * mult * math.prod(ls[i] for i in lb) * free_l \
                * free_r * math.prod(ls[i] for i in lc)
        length = eqn.params.get("length", 1) \
            if eqn.primitive.name == "scan" else 1
        for sub in eqn.params.values():
            for s in (sub if isinstance(sub, (list, tuple)) else [sub]):
                inner = getattr(s, "jaxpr", s)
                if hasattr(inner, "eqns"):
                    total += _dot_flops(inner, mult * length)
    return total


def _reference_flops(arch, kind) -> int:
    cfg = r_configs.get_config(arch, smoke=True)
    shape = SMALL[kind]
    params = jax.eval_shape(functools.partial(r_st.init_params_stacked, cfg),
                            jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((shape["global_batch"], shape["seq_len"]),
                               jnp.int32)
    # The batch's vision embeddings where the arch takes them, as the
    # port's cell gets them from `input_specs`.
    from repro.launch.specs import input_specs
    vis = input_specs(cfg, shape).get("vision_embeds")
    if kind == "prefill":
        return _dot_flops(jax.make_jaxpr(lambda p, t, v: r_st.forward_scan(
            cfg, p, t, vision_embeds=v, last_only=True)[0])(
                params, tok, vis).jaxpr)
    opt_init, opt_update = r_make_optimizer("adamw", lr=1e-4)

    def step(p, o, t, lab, v):
        loss, g = jax.value_and_grad(
            lambda p_: r_st.lm_loss_scan(cfg, p_, t, lab,
                                         vision_embeds=v))(p)
        return loss, *opt_update(p, g, o)

    return _dot_flops(jax.make_jaxpr(step)(
        params, jax.eval_shape(opt_init, params), tok, tok, vis).jaxpr)


@pytest.mark.parametrize("arch", FLOPS_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flops_are_the_reference_dot_products(runs, arch, kind):
    got = runs[2][f"{arch}/{kind}"]
    want = _reference_flops(arch, kind)
    assert want > 0
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)
