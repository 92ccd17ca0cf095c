"""LM training loops and the training launcher in the port against the
JAX package on the CPU: `train_loop`'s loss history over eight steps,
checkpoints written by either package resuming in both, and
`python -m repro_torch.launch.train` with and without `--ckpt-dir` and
`--resume` beside `repro.launch.train` with the same flags.

As in tests/test_torch_lm_train.py, the reference draws the weights,
`params_from_numpy` carries them to the port, and the batches are made
with numpy from a seed; Yi-6B's SMOKE config in float32. The loss
histories agree within LOSS_TOL, float32 summed in another order. The
launchers draw their weights each from their own generator (seed 0 in
both), so their losses are compared only to themselves: the lines they
print, and how a resumed run continues, are compared across packages.

R5 (ROADMAP queue 3) is mirrored, not fixed: a run resumed from the
checkpoint of step K replays batch K on the state after step K's update,
and the launcher numbers the resumed run's steps from 0.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt
from repro import configs as r_configs
from repro import train as r_train
from repro.launch import train as r_launch
from repro.models import transformer as r_tf
from repro_torch import checkpoint as p_ckpt
from repro_torch import train as p_train
from repro_torch.launch import train as p_launch
from repro_torch.models import transformer as p_tf

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    r_cfg = r_configs.get_config("yi_6b", smoke=True)
    r_params = r_tf.init_params(r_cfg, jax.random.PRNGKey(5))
    tree = jax.tree_util.tree_map(np.asarray, r_params)
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(r_cfg))
    return r_cfg, r_params, p_cfg, p_tf.params_from_numpy(p_cfg, tree, "cpu")


def _batch(cfg, shape, seed):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape, dtype=np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1)}

def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("optimizer,accum,compress", [
    ("adamw", 1, False), ("adafactor", 2, True)])
def test_train_loop_history_matches_reference(model, optimizer, accum,
                                              compress):
    """Eight steps of `train_loop` from the same weights on the same
    batches: the loss history within LOSS_TOL at every step."""
    r_cfg, r_params, p_cfg, p_params = model
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    batches = [_batch(r_cfg, shape, seed=20 + i) for i in range(8)]
    kw = dict(optimizer=optimizer, grad_accum=accum, compress=compress,
              max_steps=8, lr=1e-3)
    r_lc, p_lc = r_train.TrainLoopConfig(**kw), p_train.TrainLoopConfig(**kw)
    _, _, r_info = r_train.train_loop(
        r_cfg, r_lc, r_params,
        r_train.make_optimizer(optimizer, lr=r_lc.lr)[0](r_params),
        [jax.tree_util.tree_map(jnp.asarray, b) for b in batches],
        log_every=1)
    _, p_state, p_info = p_train.train_loop(
        p_cfg, p_lc, p_params,
        p_train.make_optimizer(optimizer, lr=p_lc.lr)[0](p_params),
        batches, log_every=1)
    assert [s for s, _ in p_info["history"]] == list(range(8))
    np.testing.assert_allclose([x for _, x in p_info["history"]],
                               [x for _, x in r_info["history"]],
                               atol=LOSS_TOL)
    assert p_state["step"] == 8 and p_info["seconds"] > 0
    assert (p_info["ef"] is None) == (r_info["ef"] is None) == (not compress)


# ---- checkpoints and resume ------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resume_from_either_package(tmp_path, model, writer):
    """`train_loop` with a checkpointer (compress on, so `ef` is saved)
    writes step 2 after its update; the other package's checkpoint,
    restored into a tree of the reader's own (params, opt_state, ef),
    resumes at start_step = 2 on the same batches in both packages.

    R5 (ROADMAP queue 3), mirrored: resuming at the checkpointed step
    replays its batch on the state after its update, so the resumed step
    2 differs from the first run's step 2."""
    r_cfg, r_params, p_cfg, p_params = model
    batches = [_batch(r_cfg, (2, 16), seed=40 + i) for i in range(4)]
    kw = dict(optimizer="adamw", compress=True, checkpoint_every=2, lr=1e-3)
    r_lc = r_train.TrainLoopConfig(max_steps=3, **kw)
    p_lc = p_train.TrainLoopConfig(max_steps=3, **kw)
    r_state0 = r_train.make_optimizer("adamw", lr=1e-3)[0](r_params)
    p_state0 = p_train.make_optimizer("adamw", lr=1e-3)[0](p_params)
    if writer == "port":
        _, _, first = p_train.train_loop(
            p_cfg, p_lc, p_params, p_state0, batches,
            checkpointer=p_ckpt.Checkpointer(str(tmp_path)), log_every=1)
    else:
        _, _, first = r_train.train_loop(
            r_cfg, r_lc, r_params, r_state0,
            [jax.tree_util.tree_map(jnp.asarray, b) for b in batches],
            checkpointer=r_ckpt.Checkpointer(str(tmp_path)), log_every=1)
    assert p_ckpt.latest_step(str(tmp_path)) == 2

    p_tree, step = p_ckpt.Checkpointer(str(tmp_path)).restore(
        {"params": p_params, "opt_state": p_state0,
         "ef": p_train.ef_init(p_params)})
    r_tree, r_step = r_ckpt.Checkpointer(str(tmp_path)).restore(
        {"params": r_params, "opt_state": r_state0,
         "ef": r_train.ef_init(r_params)})
    assert step == r_step == 2
    p_flat, r_flat = _flat(p_tree), _flat(r_tree)
    assert set(p_flat) == set(r_flat)
    for path in r_flat:                           # the same bytes, read twice
        np.testing.assert_array_equal(p_flat[path], r_flat[path])
    cont = dict(max_steps=4, **kw)
    _, _, p_info = p_train.train_loop(
        p_cfg, p_train.TrainLoopConfig(**cont), p_tree["params"],
        p_tree["opt_state"], batches[step:], start_step=step, log_every=1,
        ef=p_tree["ef"])
    _, _, r_info = r_train.train_loop(
        r_cfg, r_train.TrainLoopConfig(**cont),
        jax.tree_util.tree_map(jnp.asarray, r_tree["params"]),
        r_tree["opt_state"],
        [jax.tree_util.tree_map(jnp.asarray, b) for b in batches[step:]],
        start_step=r_step, log_every=1,
        ef=jax.tree_util.tree_map(jnp.asarray, r_tree["ef"]))
    assert [s for s, _ in p_info["history"]] == [2, 3]
    np.testing.assert_allclose([x for _, x in p_info["history"]],
                               [x for _, x in r_info["history"]],
                               atol=LOSS_TOL)
    # R5: step 2's batch ran twice, the second time on the post-2 state.
    assert first["history"][2][0] == p_info["history"][0][0] == 2
    assert abs(first["history"][2][1] - p_info["history"][0][1]) > LOSS_TOL


# ---- the launcher ----------------------------------------------------------


def _shape(out: str) -> list:
    """The printed lines with their numbers taken out."""
    return [re.sub(r"-?\d+(\.\d+)?", "N", ln) for ln in out.splitlines()]


def _losses(out: str) -> list:
    return [float(m.group(1)) for m in re.finditer(r"loss (\S+)", out)]


def test_launch_train_cli_on_cpu():
    """`python -m repro_torch.launch.train --arch yi_6b --steps 4 --device
    cpu` prints the reference launcher's lines: step 0's loss, then the
    seconds for 4 steps."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi_6b",
         "--steps", "4", "--device", "cpu"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _shape(proc.stdout) == ["step     N loss N", "Ns for N steps"]
    loss = _losses(proc.stdout)[0]
    assert np.isfinite(loss) and abs(loss - np.log(256)) < 0.5


def test_launch_train_checkpoints_and_resumes(tmp_path, capsys):
    """With `--ckpt-dir` both launchers checkpoint every quarter of the
    steps (the last three kept); with `--resume` both restore the newest,
    print where they resumed and go on (R5: from step 0 of the replayed
    batch); `--compress` runs the int8 error feedback."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    out = {}
    for name, main, d, extra in (("port", p_launch.main, port_dir,
                                  ["--device", "cpu"]),
                                 ("ref", r_launch.main, ref_dir, [])):
        args = ["--arch", "yi_6b", "--steps", "4", "--compress",
                "--ckpt-dir", str(d), *extra]
        main(args)
        first = capsys.readouterr().out
        main([*args, "--resume"])
        out[name] = (first, capsys.readouterr().out)
        assert sorted(p.name for p in d.iterdir()) == [
            "step_1", "step_2", "step_3"]
    assert _shape(out["port"][0]) == _shape(out["ref"][0])
    assert _shape(out["port"][1]) == _shape(out["ref"][1]) == [
        "resumed from step N", "step     N loss N", "Ns for N steps"]
    assert out["port"][1].startswith("resumed from step 3")
    # The resumed run trains on: its loss differs from the first run's.
    assert _losses(out["port"][1])[0] != _losses(out["port"][0])[0]
    # R5: numbering from 0, the resumed run wrote steps 1-3 again, 4 + 4
    # updates in its step 3.
    restored, step = p_ckpt.Checkpointer(str(port_dir)).restore(
        {"opt_state": {"step": 0}})
    assert step == 3 and int(restored["opt_state"]["step"]) == 8


@pytest.mark.parametrize("arch", ["gemma2_27b", "mixtral_8x22b",
                                  "recurrentgemma_2b", "qwen2_vl_72b"])
def test_launch_train_cli_takes_softcapped_and_moe_archs(arch, capsys):
    """`--arch gemma2_27b` (both softcaps, window 16: the softcapped
    backward), `--arch mixtral_8x22b` (every layer MoE, the aux loss in
    the objective), `--arch recurrentgemma_2b` (the RG-LRU scan and the
    temporal conv differentiated, a local attention layer) and `--arch
    qwen2_vl_72b` (M-RoPE positions and the vision block's bidirectional
    prefix over the token embeddings, no vision input, as the reference
    launcher trains it) train on the CPU through `get_config`, printing
    the reference launcher's lines, with a finite first loss near
    ln(vocab)."""
    out = {}
    for name, main, extra in (("port", p_launch.main, ["--device", "cpu"]),
                              ("ref", r_launch.main, [])):
        main(["--arch", arch, "--steps", "2", *extra])
        out[name] = capsys.readouterr().out
    assert _shape(out["port"]) == _shape(out["ref"]) == [
        "step     N loss N", "Ns for N steps"]
    loss = _losses(out["port"])[0]
    # Each launcher draws its own weights from seed 0, so the first losses
    # share only the init's distribution: RecurrentGemma's and Qwen2-VL's
    # start near 6.1 in both, Gemma-2's and Mixtral's near ln(vocab).
    assert np.isfinite(loss) and abs(loss - _losses(out["ref"])[0]) < 0.5
    if arch in ("gemma2_27b", "mixtral_8x22b"):
        assert abs(loss - np.log(256)) < 0.5
