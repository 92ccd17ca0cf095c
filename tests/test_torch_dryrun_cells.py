"""`launch.dryrun` over every arch on a sharded mesh, against
`repro.launch.dryrun`.

  * Every arch's SMOKE prefill and decode cell, and xLSTM-125M's and
    Qwen2-VL-72B's train cells, trace on a (2, 4) ("data", "model") mesh
    over the "fake" process group at `test_torch_dryrun.py`'s small
    shapes, each with the keys of the reference's `run_cell` for its kind.
  * The decode cells of Yi-6B, Gemma-2 and Mixtral at cache lengths 64 and
    128: the collective bytes a device that each added cache position
    costs are no more than the reference's cells' on the same mesh and
    lengths (its `run_cell` on 8 XLA host devices, GSPMD's Auto axes).
    The caches lie on the ranks as `launch.sharding.state_pspecs` places
    them, and each rank writes and reads its own shard.
  * FSDP forced on (every param's rows, and a stacked leaf's layer dim,
    over "data"): Yi-6B's and Qwen2-VL-72B's SMOKE decode cells and
    Qwen2-VL's train cell at 2 and 4 layers. The all-gather bytes a device
    that each added layer costs are no more than the reference's cells'
    (a layer's weights are read from the rank that holds them, never the
    whole stack gathered for each layer).
  * xLSTM-125M's SMOKE decode cell gathers no mLSTM state: its all-gather
    bytes are under one layer's c, and its collective bytes are no more
    than the reference's cell's.

The port's traces run in two subprocesses, each one fake world of 8 ranks
(`dryrun.fake_world` says why), beside one of the reference's.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import arch_ids

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"train": dict(kind="train", seq_len=32, global_batch=8),
         "prefill": dict(kind="prefill", seq_len=32, global_batch=8),
         "decode": dict(kind="decode", seq_len=64, global_batch=8)}
TRAIN_ARCHS = ("xlstm_125m", "qwen2_vl_72b")
SLOPE_ARCHS = ("yi_6b", "gemma2_27b", "mixtral_8x22b")
LENGTHS = (64, 128)
FSDP_CELLS = (("yi_6b", "decode"), ("qwen2_vl_72b", "decode"),
              ("qwen2_vl_72b", "train"))
FSDP_LAYERS = (2, 4)


def _cells():
    """(arch, kind, seq_len) of every cell the port traces here."""
    cells = [(a, k, SMALL[k]["seq_len"]) for a in arch_ids()
             for k in ("prefill", "decode")]
    cells += [(a, "train", SMALL["train"]["seq_len"]) for a in TRAIN_ARCHS]
    cells += [(a, "decode", n) for a in SLOPE_ARCHS for n in LENGTHS
              if n != SMALL["decode"]["seq_len"]]
    return cells


def _fsdp_cells():
    """(arch, kind, n_layers) of every cell traced with FSDP forced on."""
    return [(a, k, n) for a, k in FSDP_CELLS for n in FSDP_LAYERS]


_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax
    import repro.launch.dryrun as dr
    from repro.configs import get_config

    small, archs, lengths, fsdp = (json.loads(a) for a in sys.argv[1:5])
    dr.get_config = lambda arch: get_config(arch, smoke=True)
    dr.SHAPES = dict(small, **{f"decode_{n}": dict(small["decode"],
                                                   seq_len=n)
                               for n in lengths})
    dr.make_production_mesh = lambda multi_pod: jax.make_mesh(
        (2, 4), ("data", "model"), devices=jax.devices()[:8],
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {"keys": {k: dr.run_cell("yi_6b", k, False, body_costs=False)
                    for k in small}}
    for arch in archs:
        for n in lengths:
            cell = dr.run_cell(arch, f"decode_{n}", False, body_costs=False)
            assert cell["ok"], cell.get("error")
            out[f"{arch}/{n}"] = cell["collectives"]["bytes"]
    cell = dr.run_cell("xlstm_125m", "decode", False, body_costs=False)
    assert cell["ok"], cell.get("error")
    out["xlstm_125m/decode"] = cell["collectives"]
    # FSDP forced on at a layer count of the cell's own.
    tree_pspecs = dr.tree_pspecs
    dr.tree_pspecs = lambda tree, mesh, fsdp=False: tree_pspecs(
        tree, mesh, fsdp=True)
    for arch, kind, layers in fsdp:
        dr.get_config = lambda a: dataclasses.replace(
            get_config(a, smoke=True), n_layers=layers)
        cell = dr.run_cell(arch, kind, False, body_costs=False)
        assert cell["ok"], cell.get("error")
        out[f"fsdp/{arch}/{kind}/{layers}"] = cell["collectives"]
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.transformer import MESH_AXES_SINGLE

    small, cells, fsdp = (json.loads(a) for a in sys.argv[1:4])
    tree_pspecs = D.tree_pspecs

    def trace(cfg, shape, mesh):
        cell = {"arch": cfg.name, "shape": shape["kind"], "mesh": "16x16",
                "kind": shape["kind"], "ok": False, "elapsed_s": 0.0}
        try:
            cell.update(D.dryrun_cell(cfg, shape, mesh, MESH_AXES_SINGLE,
                                      body_costs=False))
            cell["ok"] = True
        except Exception as err:
            cell["error"] = f"{type(err).__name__}: {err}"[:2000]
        return cell

    out = {}
    with D.fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        for arch, kind, n in cells:
            out[f"{arch}/{kind}/{n}"] = trace(
                get_config(arch, smoke=True), dict(small[kind], seq_len=n),
                mesh)
        # FSDP forced on at a layer count of the cell's own.
        D.tree_pspecs = lambda tree, mesh, fsdp=False: tree_pspecs(
            tree, mesh, fsdp=True)
        for arch, kind, layers in fsdp:
            out[f"fsdp/{arch}/{kind}/{layers}"] = trace(dataclasses.replace(
                get_config(arch, smoke=True), n_layers=layers), small[kind],
                mesh)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs():
    """The reference's cells and the port's, the port's cells split over
    two subprocesses: ({"keys": ..., "arch/len": bytes}, {cell: result})."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells, fsdp = _cells(), _fsdp_cells()
    halves = [(cells[0::2], fsdp[0::2]), (cells[1::2], fsdp[1::2])]
    args = [(_REFERENCE, json.dumps(SMALL), json.dumps(SLOPE_ARCHS),
             json.dumps(LENGTHS), json.dumps(fsdp))]
    args += [(_PORT, json.dumps(SMALL), json.dumps(c), json.dumps(f))
             for c, f in halves]
    procs = [subprocess.Popen([sys.executable, "-c", *a], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in args]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ref, *port = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    return ref, {k: v for part in port for k, v in part.items()}


def _keys(d, prefix=""):
    """Every key path of a nested dict ("memory/temp_bytes")."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "by_kind":
            out |= _keys(v, f"{prefix}{k}/")
    return out


@pytest.mark.parametrize("arch,kind,n", _cells())
def test_cell_traces_with_the_reference_keys(runs, arch, kind, n):
    ref, port = runs
    cell = port[f"{arch}/{kind}/{n}"]
    assert cell["ok"], cell.get("error")
    want = ref["keys"][kind]
    assert want["ok"], want.get("error")
    assert _keys(cell) == _keys(want), (arch, kind)


@pytest.mark.parametrize("arch", SLOPE_ARCHS)
def test_decode_collectives_per_cache_position_within_the_reference(
        runs, arch):
    """Bytes a device per added cache position, from the two lengths:
    the reference's GSPMD moves about 1.3 local caches a step (an
    all-to-all that reshards them); the port moves only the token's
    tensors and the partial scores."""
    ref, port = runs
    lo, hi = LENGTHS

    def slope(get):
        return (get(hi) - get(lo)) / (hi - lo)

    got = slope(lambda n: port[f"{arch}/decode/{n}"]["collectives"]["bytes"])
    want = slope(lambda n: ref[f"{arch}/{n}"])
    assert want > 0
    assert got <= want, (got, want)


def _all_gather(collectives) -> int:
    return collectives["by_kind"].get("all-gather", 0)


@pytest.mark.parametrize("arch,kind", FSDP_CELLS)
def test_fsdp_all_gather_per_layer_within_the_reference(runs, arch, kind):
    """FSDP forced on, all-gather bytes a device per added layer, from
    the two layer counts: before the port read a stacked leaf's layer
    from its shards, each layer's view gathered the whole stack."""
    ref, port = runs
    lo, hi = FSDP_LAYERS
    cells = {n: port[f"fsdp/{arch}/{kind}/{n}"] for n in FSDP_LAYERS}
    for cell in cells.values():
        assert cell["ok"], cell.get("error")
    got = (_all_gather(cells[hi]["collectives"])
           - _all_gather(cells[lo]["collectives"])) / (hi - lo)
    want = (_all_gather(ref[f"fsdp/{arch}/{kind}/{hi}"])
            - _all_gather(ref[f"fsdp/{arch}/{kind}/{lo}"])) / (hi - lo)
    assert got <= want, (got, want)


def test_mlstm_decode_gathers_no_state(runs):
    """xLSTM-125M's SMOKE decode cell: each rank updates its own shard of
    the mLSTM state c and sums the partial numerator and denominator, so
    its all-gather bytes are under one mLSTM layer's c (B, H, hd, hd) f32,
    and its collective bytes are no more than the reference's."""
    from repro_torch.configs import get_config
    ref, port = runs
    cfg = get_config("xlstm_125m", smoke=True)
    cell = port[f"xlstm_125m/decode/{SMALL['decode']['seq_len']}"]
    assert cell["ok"], cell.get("error")
    hd = cfg.d_model // cfg.n_heads
    c_bytes = SMALL["decode"]["global_batch"] * cfg.n_heads * hd * hd * 4
    assert _all_gather(cell["collectives"]) < c_bytes, cell["collectives"]
    want = ref["xlstm_125m/decode"]["bytes"]
    assert cell["collectives"]["bytes"] <= want, (cell["collectives"], want)


def test_jobs_run_each_cell_in_a_process_of_its_own(tmp_path):
    """`launch.dryrun --jobs 2`: the cells of its own list, each in a
    process of its own, `[run ]` and `[done]` for each and its JSON
    written (two cells `shape_applicable` skips, so that no trace runs)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek_7b", "--shape", "long_500k", "--mesh", "both", "--jobs",
         "2", "--out", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for mesh in ("single", "multi"):
        name = f"deepseek_7b__long_500k__{mesh}"
        assert f"[run ] {name}" in out.stdout
        assert f"[done] {name}: SKIP" in out.stdout
        assert "skipped" in json.loads((tmp_path / f"{name}.json")
                                       .read_text())
        assert (tmp_path / f"{name}.log").exists()
