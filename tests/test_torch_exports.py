"""The port's public names against the JAX package's: for each subpackage
of `repro` that declares `__all__`, the port's `__all__` holds every name
but those still to port (`STILL_TO_PORT`, empty since `models.encode`
came with the encoder-decoder), and each name resolves. `kernels` exports the four wrappers and `ref`, as
`repro.kernels` does, and importing it builds nothing. `train` holds the
reference's names exactly since the LM half of the train loop and the
gradient compression were ported. The launch layer's modules and
`models.moe_shard_map`, which no `__all__` lists, hold every public
top-level name of their reference modules."""
import ast
import importlib
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ["checkpoint", "core", "data", "io", "kernels", "models",
               "runtime", "sparse", "train"]
# Names of the reference's `__all__`s the port does not have yet: none.
STILL_TO_PORT = {}
# Subpackages whose `__all__` must equal the reference's exactly.
EQUAL = ["data", "kernels", "runtime", "sparse", "train"]
# Modules without an `__all__`, held to their reference's top-level names;
# a tree of NamedShardings becomes one of DTensor placements.
MODULES = ["launch.mesh", "launch.sharding", "launch.specs",
           "launch.dryrun", "launch.hlo_analysis", "models.moe_shard_map"]
RENAMED = {"tree_shardings": "tree_placements"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_hold_the_reference_names(sub):
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == STILL_TO_PORT.get(sub, set())
    for name in port.__all__:
        assert hasattr(port, name), name
    if sub in EQUAL:
        assert sorted(port.__all__) == sorted(ref.__all__)


def test_kernels_exports_the_wrappers_not_the_modules():
    import types

    import repro_torch.kernels as k
    from repro_torch.kernels import bcsr_spmm, ops, ref
    assert bcsr_spmm is ops.bcsr_spmm
    for name in ("fused_gcn_layer", "decode_attention", "flash_attention"):
        assert getattr(k, name) is getattr(ops, name)
    assert isinstance(ref, types.ModuleType)
    mod = importlib.import_module("repro_torch.kernels.bcsr_spmm")
    assert isinstance(mod, types.ModuleType) and mod is not bcsr_spmm
    assert hasattr(mod, "bcsr_spmm_cuda") and hasattr(mod, "LAUNCHES")


def test_importing_kernels_builds_nothing():
    """In a fresh interpreter with every subprocess start refused,
    `import repro_torch.kernels` loads no library and starts no nvcc."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'started a process: {a!r}')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import repro_torch.kernels as k\n"
        "from repro_torch.kernels import bcsr_spmm, flash_attention\n"
        "b = sys.modules['repro_torch.kernels.build']\n"
        "sys.exit(0 if b._lib is None else 1)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("mod", MODULES)
def test_port_modules_hold_the_reference_top_level_names(mod):
    path = ROOT / "src" / "repro" / (mod.replace(".", "/") + ".py")
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    public = {n for n in names if not n.startswith("_")}
    assert public
    port = importlib.import_module(f"repro_torch.{mod}")
    missing = sorted(n for n in public if not hasattr(port, RENAMED.get(n, n)))
    assert not missing
