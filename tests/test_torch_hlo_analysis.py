"""`launch.hlo_analysis` against `repro.launch.hlo_analysis`.

The HLO parsers (`collective_bytes`, `collective_count`) are held to the
reference's exactly: on hand-written lines of each kind (async pairs, tuple
shapes, an XLA:CPU-promoted f32 all-reduce among them) and on HLO text the
reference lowers and compiles in a subprocess on 8 XLA host devices, a
sharded matmul for which GSPMD emits an all-reduce and an all-gather.
`graph_collective_bytes` and `graph_collective_count` are held to a hand
count on the FX graphs `torch.compile` captures of three DTensor
redistributions on a (2, 4) mesh over the "fake" process group.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import pytest
import torch

from repro.launch import hlo_analysis as r_hlo
from repro_torch.launch import hlo_analysis as p_hlo

ROOT = pathlib.Path(__file__).resolve().parents[1]

HAND_LINES = [
    "%ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %p), dimensions={0}",
    "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), to_apply=%add",
    "%arp = f32[256,4]{1,0} all-reduce(f32[256,4]{1,0} %x), "
    "to_apply=%add.clone_promoted",
    "%rs = f16[32]{0} reduce-scatter(f16[256]{0} %y), dimensions={0}",
    "%a2a = s32[4,4]{1,0} all-to-all(s32[4,4]{1,0} %z), dimensions={0}",
    "%cp = u8[100]{0} collective-permute(u8[100]{0} %w), "
    "source_target_pairs={{0,1}}",
    "%ags = (bf16[2,64]{1,0}, bf16[16,64]{1,0}) all-gather-start("
    "bf16[2,64]{1,0} %q), dimensions={0}",
    "%agd = bf16[16,64]{1,0} all-gather-done((bf16[2,64]{1,0}, "
    "bf16[16,64]{1,0}) %ags)",
    "%ars = f32[8]{0} all-reduce-start(f32[8]{0} %r), to_apply=%add",
    "%ard = f32[8]{0} all-reduce-done(f32[8]{0} %ars)",
    "%t = (f32[4]{0}, s8[4]{0}) all-reduce(f32[4]{0} %a, s8[4]{0} %b), "
    "to_apply=%add",
    "%n = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)",
]


@pytest.mark.parametrize("line", HAND_LINES)
def test_each_hand_written_line_parses_as_the_reference(line):
    assert p_hlo.collective_bytes(line) == r_hlo.collective_bytes(line)
    assert p_hlo.collective_bytes(line, undo_cpu_promotion=False) == \
        r_hlo.collective_bytes(line, undo_cpu_promotion=False)
    assert p_hlo.collective_count(line) == r_hlo.collective_count(line)


def test_hand_written_module_parses_as_the_reference():
    text = "\n".join(HAND_LINES)
    total, kinds = p_hlo.collective_bytes(text)
    assert (total, kinds) == r_hlo.collective_bytes(text)
    assert set(kinds) == set(p_hlo._COLLECTIVES)
    assert p_hlo.collective_count(text) == r_hlo.collective_count(text) == 9


_LOWER = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    a = jax.ShapeDtypeStruct((64, 256), jnp.float32)
    w = jax.ShapeDtypeStruct((256, 128), jnp.bfloat16)
    # Contraction over the model-sharded dim: partial sums (all-reduce);
    # the output replicated: the data-sharded rows gathered (all-gather).
    f = jax.jit(lambda a, w: (a @ w.astype(jnp.float32)).astype(jnp.bfloat16),
                in_shardings=(NamedSharding(mesh, P("data", "model")),
                              NamedSharding(mesh, P("model", None))),
                out_shardings=NamedSharding(mesh, P()))
    print(f.lower(a, w).compile().as_text())
""")


def test_lowered_hlo_parses_as_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _LOWER], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = proc.stdout
    total, kinds = p_hlo.collective_bytes(text)
    assert {"all-reduce", "all-gather"} <= set(kinds)
    assert total > 0
    for promote in (True, False):
        assert p_hlo.collective_bytes(text, promote) == \
            r_hlo.collective_bytes(text, promote)
    assert p_hlo.collective_count(text) == r_hlo.collective_count(text)


def _captured(fn, *args):
    """The forward graph `torch.compile` captures of fn(*args)."""
    from functorch.compile import aot_module_simplified, make_boxed_func
    graphs = []

    def backend(gm, inputs):
        def keep(graph, _):
            graphs.append(graph)
            return make_boxed_func(graph.forward)
        return aot_module_simplified(gm, inputs, fw_compiler=keep)

    torch._dynamo.reset()
    torch.compile(fn, backend=backend, fullgraph=True)(*args)
    torch._dynamo.reset()
    return graphs[0]


# (from, to, the collective's kind, its per-device result bytes): x is a
# (8, 16) f32 global tensor on a (2, 4) ("data", "model") mesh.
REDISTRIBUTIONS = [
    ("Shard(0),Replicate", "Replicate,Replicate", "all-gather", 8 * 16 * 4),
    ("Replicate,Partial", "Replicate,Replicate", "all-reduce", 8 * 16 * 4),
    ("Replicate,Partial", "Replicate,Shard(0)", "reduce-scatter",
     2 * 16 * 4),
]


def _placements(text):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [eval(p, {"Shard": Shard, "Replicate": Replicate(),
                     "Partial": Partial()}) for p in text.split(",")]


@pytest.mark.parametrize("src,dst,kind,nbytes", REDISTRIBUTIONS)
def test_graph_collectives_of_known_redistributions(src, dst, kind, nbytes):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.dryrun import fake_world
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        src_pl, dst_pl = _placements(src), _placements(dst)
        local = (8 // (2 if "Shard" in src.split(",")[0] else 1), 16)
        x = DTensor.from_local(torch.zeros(local), mesh, src_pl,
                               run_check=False)
        gm = _captured(lambda t: t.redistribute(mesh, dst_pl) * 2.0, x)
    assert p_hlo.graph_collective_bytes(gm) == (nbytes, {kind: nbytes})
    assert p_hlo.graph_collective_count(gm) == 1
    waits = [n for n in gm.graph.nodes if "wait_tensor" in str(n.target)]
    assert len(waits) == 1                  # present, and not counted
