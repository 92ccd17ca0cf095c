"""Import hygiene of the PyTorch port: `repro_torch` and `chip_smoke.py`
import neither JAX nor anything of the JAX package `repro`."""
import ast
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (the parity files import both; so does this one)
import pytest
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The LM serving path's modules, which must be among those walked.
LM_MODULES = [
    "repro_torch.configs.deepseek_7b", "repro_torch.configs.yi_6b",
    "repro_torch.configs.yi_9b", "repro_torch.kernels.build",
    "repro_torch.kernels.decode_attn", "repro_torch.kernels.flash_attn",
    "repro_torch.models.config", "repro_torch.models.layers",
    "repro_torch.models.transformer",
]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top.startswith("jax") or top == "repro"


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        f"missing = sorted(set({LM_MODULES!r}) - set(names))\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('jax')\n"
        "             or m.split('.')[0] == 'repro')\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 30 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_has_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


# The scheduler slice's modules: each must import alone, in a fresh
# interpreter, without pulling in JAX or the JAX package.
SLICE_MODULES = [
    "repro_torch.core.pipeline", "repro_torch.core.analysis",
    "repro_torch.core.passes", "repro_torch.core.scheduler",
    "repro_torch.core.spgemm", "repro_torch.core.robw",
    "repro_torch.io.tiers", "repro_torch.io.segment_cache",
    "repro_torch.runtime.engine", "repro_torch.launch.serve",
    "repro_torch.io.shard_cache", "repro_torch.checkpoint.checkpointer",
    "repro_torch.core.calibration",
    # The autotune, partition and edge-update slice.
    "repro_torch.core.autotune", "repro_torch.sparse.partition",
    "repro_torch.sparse.updates", "repro_torch.data.graphs",
    # The serving loop and supervisor slice.
    "repro_torch.runtime.serving_loop", "repro_torch.runtime.supervisor",
    "repro_torch.data.tokens", "repro_torch.kernels",
    # The launch layer and the expert-parallel MoE.
    "repro_torch.launch.mesh", "repro_torch.launch.sharding",
    "repro_torch.launch.specs", "repro_torch.models.moe_shard_map",
    # The dry run.
    "repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_scheduler_slice_module_imports_alone(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('jax')\n"
        "             or m.split('.')[0] == 'repro')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
