"""`models.moe_shard_map` against the reference's `moe_ffn_shard_map`.

One run for all cases: 8 `gloo` ranks over a (2, 4) ("data", "model")
DeviceMesh (a FileStore under tmp_path, no port), and beside them the
reference's shard_map and `jax.value_and_grad` of it in a subprocess with
--xla_force_host_platform_device_count=8, the reference test's setting:
Kimi K2 SMOKE with 8 experts, top 2, x (4, 8, d), the same numpy inputs.
The loss is Σ out·g + aux; each rank takes Σ out·g over its shard / |model|
(its model group holds |model| copies of the shard's output) + aux / 8, so
the ranks' losses sum to it, and a replicated operand's gradient is the
sum of its replicas' (x over the model axis, the banks over the data axis,
the router over all 8)."""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4                       # the reference test's
N_DATA, N_MODEL = 2, 4
CASES = {"no_drops": 8.0, "drops": 1.0}   # capacity factors
BANKS = ("w_gate", "w_up", "w_down")

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.kernels.compat import use_mesh
    from repro.models.layers import moe_ffn
    from repro.models.moe_shard_map import moe_ffn_shard_map

    d = sys.argv[1]
    inp = dict(np.load(f"{d}/inputs.npz"))
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out = {}
    for case, cf in (("no_drops", 8.0), ("drops", 1.0)):
        cfg = dataclasses.replace(get_config("kimi_k2_1t_a32b", smoke=True),
                                  n_experts=8, top_k=2, capacity_factor=cf)
        p = {k: jnp.asarray(inp[k]) for k in
             ("w_router", "w_gate", "w_up", "w_down")}
        x, g = jnp.asarray(inp["x"]), jnp.asarray(inp["g"])

        def loss(p_, x_):
            o, aux = moe_ffn_shard_map(cfg, p_, x_, mesh, ("data",), "model")
            return jnp.sum(o * g) + aux, (o, aux)

        with use_mesh(mesh):
            (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
        out[f"{case}/out"], out[f"{case}/aux"] = np.asarray(o), np.asarray(aux)
        out[f"{case}/grad_x"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{case}/grad_{k}"] = np.asarray(v)
        out[f"{case}/moe_ffn"] = np.asarray(moe_ffn(cfg, p, x)[0])
    np.savez(f"{d}/reference.npz", **out)
""")

_RANK = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.models.moe_shard_map import moe_ffn_shard_map

    torch.set_num_threads(1)
    d, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", 8),
                            rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    i, j = mesh.get_coordinate()
    inp = {k: torch.from_numpy(v) for k, v in np.load(f"{d}/inputs.npz").items()}
    out = {}
    for case, cf in (("no_drops", 8.0), ("drops", 1.0)):
        cfg = dataclasses.replace(get_config("kimi_k2_1t_a32b", smoke=True),
                                  n_experts=8, top_k=2, capacity_factor=cf)
        p = {"w_router": inp["w_router"].clone().requires_grad_(True)}
        for k in ("w_gate", "w_up", "w_down"):
            p[k] = inp[k][2 * j:2 * j + 2].clone().requires_grad_(True)
        x = inp["x"][2 * i:2 * i + 2].clone().requires_grad_(True)
        o, aux = moe_ffn_shard_map(cfg, p, x, mesh, ("data",), "model")
        loss = torch.sum(o * inp["g"][2 * i:2 * i + 2]) / 4 + aux / 8
        loss.backward()
        out[f"{case}/out"], out[f"{case}/aux"] = o.detach(), aux.detach()
        out[f"{case}/grad_x"] = x.grad
        for k, v in p.items():
            out[f"{case}/grad_{k}"] = v.grad
    try:
        moe_ffn_shard_map(dataclasses.replace(cfg, n_experts=6), p,
                          inp["x"][:2], mesh, ("data",), "model")
        out["refused"] = torch.tensor(0)
    except ValueError:
        out["refused"] = torch.tensor(1)
    np.savez(f"{d}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()
""")


def _inputs(d_model, d_ff, e, seed=0):
    rng = np.random.default_rng(seed)

    def normal(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    s = d_model ** -0.5
    return {"w_router": normal(d_model, e, std=s),
            "w_gate": normal(e, d_model, d_ff, std=s),
            "w_up": normal(e, d_model, d_ff, std=s),
            "w_down": normal(e, d_ff, d_model, std=d_ff ** -0.5),
            "x": normal(4, 8, d_model), "g": normal(4, 8, d_model)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's results and the 8 ranks', from one run of each."""
    from repro_torch.configs import get_config
    d = tmp_path_factory.mktemp("moe_shard_map")
    cfg = get_config("kimi_k2_1t_a32b", smoke=True)
    inputs = _inputs(cfg.d_model, cfg.expert_d_ff, 8)
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _RANK, str(d), str(r)],
                               env=env, cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for r in range(N_DATA * N_MODEL)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz"))
             for r in range(N_DATA * N_MODEL)]
    return inputs, dict(np.load(d / "reference.npz")), ranks


def _global(ranks, case, name):
    """The port's global value of `name` from the 8 ranks' (rank = 4·i + j
    at data index i, model index j)."""
    at = [[ranks[N_MODEL * i + j][f"{case}/{name}"] for j in range(N_MODEL)]
          for i in range(N_DATA)]
    if name == "out":            # each model group's copies agree
        for row in at:
            for copy in row[1:]:
                np.testing.assert_array_equal(copy, row[0])
        return np.concatenate([row[0] for row in at])
    if name == "grad_x":         # x is replicated over the model axis
        return np.concatenate([sum(row) for row in at])
    if name == "grad_w_router":  # ... the router over the whole mesh
        return sum(sum(row) for row in at)
    # a bank: experts over the model axis, replicated over the data axis
    return np.concatenate([sum(at[i][j] for i in range(N_DATA))
                           for j in range(N_MODEL)])


def _err(a, b) -> float:
    assert a.shape == b.shape
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("case", list(CASES))
def test_output_and_aux_match_the_reference_shard_map(run, case):
    _, ref, ranks = run
    assert _err(_global(ranks, case, "out"), ref[f"{case}/out"]) < TOL
    for r in ranks:             # the aux, averaged over the mesh, everywhere
        assert abs(float(r[f"{case}/aux"]) - float(ref[f"{case}/aux"])) < TOL
    if case == "no_drops":      # nothing dropped: moe_ffn's function too
        assert _err(_global(ranks, case, "out"), ref[f"{case}/moe_ffn"]) < TOL


@pytest.mark.parametrize("name", ["x", "w_router", *BANKS])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_the_reference_shard_map(run, case, name):
    _, ref, ranks = run
    want = ref[f"{case}/grad_{name}"]
    assert float(np.abs(want).max()) > 0.1
    assert _err(_global(ranks, case, f"grad_{name}"), want) < TOL


def test_the_dropping_case_drops(run):
    """At capacity factor 1 the per-rank capacity (8 slots a destination
    for 16 tokens' 32 assignments) binds: the output is not moe_ffn's."""
    _, ref, ranks = run
    assert _err(ref["drops/out"], ref["drops/moe_ffn"]) > 1e-2
    assert _err(_global(ranks, "drops", "out"),
                _global(ranks, "no_drops", "out")) > 1e-2


def test_experts_that_do_not_divide_the_model_axis_raise(run):
    _, _, ranks = run
    assert all(int(r["refused"]) == 1 for r in ranks)
