"""The launch layer's policy against the JAX package's: `launch.sharding`'s
PartitionSpecs for every arch's full-size stacked params (meta tensors
against `jax.eval_shape`), optimizer and decode states, batches, the
DTensor placements they imply, `launch.specs.input_specs` and
`launch.mesh`'s meshes. Production meshes need 256 or 512 ranks: they are
built in a subprocess over the "fake" process-group backend."""
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as R_SHAPES
from repro.configs import arch_ids
from repro.configs import get_config as r_get_config
from repro.kernels.compat import make_abstract_mesh
from repro.launch import mesh as r_mesh
from repro.launch import sharding as r_sh
from repro.launch.specs import input_specs as r_input_specs
from repro.models.stacked import init_decode_state_stacked as r_state
from repro.models.stacked import init_params_stacked as r_init
from repro.train import optim as r_optim
from repro_torch.configs import SHAPES, get_config
from repro_torch.io.shard_cache import ShardedSegmentCache
from repro_torch.launch import mesh as p_mesh
from repro_torch.launch import sharding as p_sh
from repro_torch.launch.specs import input_specs
from repro_torch.models.stacked import init_decode_state_stacked, \
    init_params_stacked
from repro_torch.train import optim as p_optim

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODE = SHAPES["decode_32k"]


def _meshes(name):
    shape, names = MESHES[name]
    return make_abstract_mesh(shape, names), p_mesh.AbstractMesh(shape, names)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = r_get_config(arch)
    return jax.eval_shape(lambda: r_init(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return init_params_stacked(get_config(arch), None, device="meta")


def _ref_flat(tree):
    """{path: entries} of a reference tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {r_sh._path_str(path): tuple(spec) for path, spec in flat}


def _flat(tree, path=""):
    """{path: leaf} of a port tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}" if path else str(k)))
    return out


def _port_flat(tree):
    flat = _flat(tree)
    assert all(isinstance(s, p_sh.PartitionSpec) for s in flat.values())
    return {path: tuple(spec) for path, spec in flat.items()}


def _same(ref_tree, port_tree):
    ref, port = _ref_flat(ref_tree), _port_flat(port_tree)
    assert sorted(ref) == sorted(port)
    bad = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert not bad, bad
    return ref


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", arch_ids())
def test_tree_pspecs_match_the_reference(arch, mesh, fsdp):
    r_m, p_m = _meshes(mesh)
    _same(r_sh.tree_pspecs(_ref_params(arch), r_m, fsdp=fsdp),
          p_sh.tree_pspecs(_port_params(arch), p_m, fsdp=fsdp))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", arch_ids())
def test_param_rules_divide(arch, mesh):
    """Every spec the rules give divides the dims it shards, on the port's
    own paths (where the rules apply), both production meshes, with and
    without FSDP."""
    p_m = _meshes(mesh)[1]
    sizes = dict(zip(*MESHES[mesh][::-1]))
    params = _port_params(arch)
    for fsdp in (False, True):
        specs = p_sh.tree_pspecs(params, p_m, fsdp=fsdp)
        shapes = _flat(params)
        for path, spec in _port_flat(specs).items():
            for dim, axis in zip(shapes[path].shape, spec):
                size = int(np.prod([sizes[a] for a in (
                    axis if isinstance(axis, tuple) else (axis,))
                    if a is not None]))
                assert dim % size == 0, (path, shapes[path].shape, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["mixtral_8x22b", "kimi_k2_1t_a32b"])
def test_opt_state_pspecs_match_the_reference(arch, opt, mesh):
    r_m, p_m = _meshes(mesh)
    r_state_tree = jax.eval_shape(getattr(r_optim, f"{opt}_init"),
                                  _ref_params(arch))
    p_state_tree = getattr(p_optim, f"{opt}_init")(_port_params(arch))
    ref = r_sh.opt_state_pspecs(r_state_tree, None, r_m)
    port = p_sh.opt_state_pspecs(p_state_tree, None, p_m)
    assert sorted(ref) == sorted(port)
    for key in ref:
        _same(ref[key], port[key])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", arch_ids())
def test_state_pspecs_match_the_reference(arch, mesh):
    """Decode state at decode_32k (batch 128, 32,768 positions)."""
    r_m, p_m = _meshes(mesh)
    b, s = DECODE["global_batch"], DECODE["seq_len"]
    ref = jax.eval_shape(lambda: r_state(r_get_config(arch), b, s))
    port = init_decode_state_stacked(get_config(arch), b, s, device="meta")
    _same(r_sh.state_pspecs(ref, r_m), p_sh.state_pspecs(port, p_m))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [(256, 4096), (1, 4096), (32, 32768),
                                   (128, 1), (48, 7, 3), (2, 5)])
def test_batch_pspec_matches_the_reference(shape, mesh):
    r_m, p_m = _meshes(mesh)
    got = p_sh.batch_pspec(shape, p_m)
    assert tuple(got) == tuple(r_sh.batch_pspec(shape, r_m))
    if shape[0] == 1:
        assert got[0] is None                    # batch 1 replicates


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", arch_ids())
def test_input_specs_match_the_reference(arch, shape):
    assert SHAPES[shape] == R_SHAPES[shape]
    ref = r_input_specs(r_get_config(arch), R_SHAPES[shape])
    port = input_specs(get_config(arch), SHAPES[shape])
    assert sorted(port) == sorted(ref)
    for key, sds in ref.items():
        t = port[key]
        assert t.is_meta and tuple(t.shape) == tuple(sds.shape), key
        assert str(t.dtype).removeprefix("torch.") == str(sds.dtype), key


def test_input_specs_refuse_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown shape kind"):
        input_specs(get_config("yi_6b"), {"kind": "score", "seq_len": 8,
                                          "global_batch": 1})


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axes_match_the_reference(mesh):
    r_m, p_m = _meshes(mesh)
    assert p_mesh.data_axes(p_m) == r_mesh.data_axes(r_m)
    assert p_mesh.model_axis(p_m) == r_mesh.model_axis(r_m) == "model"
    assert p_m.axis_names == tuple(r_m.axis_names)


def test_placements_shard_a_dim_over_both_data_axes():
    from torch.distributed.tensor import Replicate, Shard
    # The single-pod mesh's data axes, fitted to ("data",), read "data",
    # as jax.sharding.PartitionSpec keeps a one-name tuple.
    single = p_mesh.AbstractMesh(*MESHES["single"])
    spec = p_sh.param_pspec("scan/0/moe/w_gate", (8, 6144, 16384), single,
                            fsdp=True)
    assert tuple(spec) == (None, "data", "model")
    assert tuple(p_sh.PartitionSpec(("data",), ["pod", "data"])) == (
        "data", ("pod", "data"))
    assert p_sh.placements(spec, single) == (Shard(1), Shard(2))
    m = p_mesh.AbstractMesh(*MESHES["multi"])
    spec = p_sh.param_pspec("scan/0/moe/w_gate", (8, 6144, 16384), m,
                            fsdp=True)
    assert tuple(spec) == (None, ("pod", "data"), "model")
    assert p_sh.placements(spec, m) == (Shard(1), Shard(1), Shard(2))
    assert p_sh.local_shape((8, 6144, 16384), spec, m) == (8, 192, 1024)
    assert p_sh.placements(p_sh.PartitionSpec(None, None), m) == (
        Replicate(),) * 3


def test_make_cache_mesh_raises_past_the_device_count():
    with pytest.raises(ValueError, match="available devices"):
        p_mesh.make_cache_mesh(torch.cuda.device_count() + 1)


def test_make_cache_mesh_on_the_cpu_feeds_the_sharded_cache():
    grid = p_mesh.make_cache_mesh(4, device="cpu")
    assert grid.axis_names == ("cache",) and grid.shape == (4,)
    cache = ShardedSegmentCache.from_mesh(grid, 1 << 12, local_index=2)
    assert cache.n_shards == 4 and cache.local_shard == 2
    assert cache.devices == [torch.device("cpu")] * 4


# ---- production meshes on the fake backend ---------------------------------

_FAKE = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M, sharding as S
    from repro_torch.models import init_params
    from repro_torch.models.stacked import init_params_stacked

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}" if path else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}" if path else str(i))
        else:
            yield path, tree

    out = {}
    for multi, world in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        mesh = M.make_production_mesh(multi_pod=multi, device_type="cpu")
        rec = {"names": list(mesh.mesh_dim_names),
               "shape": list(mesh.shape), "data_axes": list(M.data_axes(mesh)),
               "leaves": {}}
        for arch in sys.argv[1:]:
            flat = init_params(get_config(arch), None, device="meta")
            for tree in (init_params_stacked(get_config(arch), None,
                                             device="meta"),
                         {**flat, "layers": flat["layers"][:1]}):
                specs = dict(walk(S.tree_pspecs(tree, mesh, fsdp=True)))
                places = dict(walk(S.tree_placements(tree, mesh,
                                                     fsdp=True)))
                for path, leaf in walk(tree):
                    local = distribute_tensor(leaf, mesh,
                                              list(places[path]))
                    rec["leaves"][f"{arch}:{path}"] = [
                        list(local.to_local().shape),
                        list(S.local_shape(leaf.shape, specs[path], mesh)),
                        str(specs[path])]
        out["multi" if multi else "single"] = rec
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_production_meshes_on_the_fake_backend():
    """`make_production_mesh` of 256 and 512 ranks; each Mixtral and Kimi
    K2 leaf, stacked and in the first layer unstacked (where the expert
    banks' rules apply), distributed by `tree_placements` has the shard
    shape its spec implies."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _FAKE, "mixtral_8x22b", "kimi_k2_1t_a32b"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (shape, names) in MESHES.items():
        rec = out[name]
        assert rec["names"] == list(names) and rec["shape"] == list(shape)
        assert rec["data_axes"] == [a for a in names if a != "model"]
        assert len(rec["leaves"]) > 40
        bad = {k: v for k, v in rec["leaves"].items() if v[0] != v[1]}
        assert not bad, bad
        # Kimi K2's 384 experts shard over "model" (EP); Mixtral's 8 do
        # not divide 16, so its experts are split inside (TP).
        data = "'data'" if name == "single" else "('pod', 'data')"
        kimi = rec["leaves"]["kimi_k2_1t_a32b:layers/0/moe/w_gate"]
        assert kimi[2] == f"PartitionSpec('model', {data}, None)", kimi
        mixtral = rec["leaves"]["mixtral_8x22b:layers/0/moe/w_gate"]
        assert mixtral[2] == f"PartitionSpec(None, {data}, 'model')", mixtral
