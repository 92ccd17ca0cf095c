"""The sharding hints (`mesh_axes`) over DTensor against the reference's
`with_sharding_constraint`s.

One run for all cases: 8 `gloo` ranks over a (2, 4) ("data", "model")
DeviceMesh (a FileStore under tmp_path, no port), each leaf of the params
a DTensor placed by `launch.sharding.tree_placements`, the tokens by
`batch_pspec`, running `forward` and `lm_loss` (and its gradients) with
`MESH_AXES_SINGLE`; beside them, the reference jitted on 8 XLA host
devices in a subprocess (--xla_force_host_platform_device_count=8) with
the same specs under its mesh (Auto axes: GSPMD's, for which the reference
wrote its hints). Yi-6B's and Mixtral's SMOKE configs, the
reference's params carried across, the same numpy tokens. The port's
DTensor results are held to the single-process port on plain tensors and
to the reference, the logits within test_torch_lm.py's LOGIT_TOL, the loss
within its LOSS_TOL, the gradients within test_torch_lm_train.py's
LM_GRAD_TOL relative to each tensor's largest value, and `compress_grads`'
int8 scales on the DTensor gradients to the single process's.

The same ranks run `decode_step` for Yi-6B's and Gemma-2's SMOKE configs
(Gemma-2's local layers on rings of 16 slots, past their wrap) with the
caches DTensors placed by `launch.sharding.state_pspecs`, each rank
writing and reading its own shard: with the params replicated DTensors,
every step's logits and the final caches (and rings' `slot_pos`) equal the
single process's plain `decode_step` bit for bit; with the params placed
by `tree_placements`, the logits are within LOGIT_TOL.

The same ranks also run `mlstm_step` on states placed by `state_pspecs`
(each rank updating its own shard of c and summing the partial numerator
and denominator over the key dim's mesh dims) against the plain step,
within MLSTM_TOL, and stacked Yi-6B with FSDP on (`forward_scan`,
`lm_loss_scan` and its gradients, each layer read from the rank that holds
it) against the plain calls.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import transformer as r_tf
from repro_torch.models import transformer as p_tf

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4          # tests/test_torch_lm.py's, on forward's logits
LOSS_TOL = 1e-5           # ... on lm_loss
LM_GRAD_TOL = 1e-5        # tests/test_torch_lm_train.py's, relative
MLSTM_TOL = 1e-6          # f32, relative: the key dim's sums reordered
ARCHS = ("yi_6b", "mixtral_8x22b")
DECODE_ARCHS = ("yi_6b", "gemma2_27b")
B, S = 4, 16
DECODE_STEPS, DECODE_LEN = 20, 24     # past Gemma-2 SMOKE's window of 16

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_config
    from repro.kernels.compat import use_mesh
    from repro.launch.sharding import batch_pspec, tree_shardings
    from repro.models.transformer import (MESH_AXES_SINGLE, forward,
                                          init_params, lm_loss)

    d = sys.argv[1]
    # GSPMD's axes, for which the hints are constraints: JAX 0.9's default
    # (Explicit) turns with_sharding_constraint into an assert.
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in sys.argv[2:]:
        cfg = get_config(arch, smoke=True)
        inp = dict(np.load(f"{d}/{arch}.npz"))
        params = init_params(cfg, jax.random.PRNGKey(5))
        p_sh = tree_shardings(params, mesh)
        t_sh = NamedSharding(mesh, batch_pspec(inp["tokens"].shape, mesh))
        tokens = jnp.asarray(inp["tokens"])
        labels = jnp.asarray(inp["labels"])
        with use_mesh(mesh):
            logits, aux = jax.jit(
                lambda p, t: forward(cfg, p, t, mesh_axes=MESH_AXES_SINGLE),
                in_shardings=(p_sh, t_sh))(params, tokens)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, t, l: lm_loss(cfg, p, t, l,
                                        mesh_axes=MESH_AXES_SINGLE)),
                in_shardings=(p_sh, t_sh, t_sh))(params, tokens, labels)
        out[f"{arch}/logits"], out[f"{arch}/aux"] = (np.asarray(logits),
                                                     np.asarray(aux))
        out[f"{arch}/loss"] = np.asarray(loss)
        flat, _ = jax.tree_util.tree_flatten_with_path(grads)
        for path, g in flat:
            out[f"{arch}/grad/" + jax.tree_util.keystr(path)] = np.asarray(g)
    np.savez(f"{d}/reference.npz", **out)
""")

_RANK = textwrap.dedent("""
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import (batch_pspec, placements,
                                             tree_placements)
    from repro_torch.models.transformer import (MESH_AXES_SINGLE, forward,
                                                lm_loss, params_from_numpy)
    from repro_torch.train.compression import compress_grads, ef_init
    from repro_torch.train.optim import tree_leaves, tree_map

    torch.set_num_threads(1)
    d, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", 8),
                            rank=rank, world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out = {}
    for arch in sys.argv[3:]:
        cfg = get_config(arch, smoke=True)
        inp = dict(np.load(f"{d}/{arch}.npz"))
        tree = np.load(f"{d}/{arch}_params.npz")
        params = params_from_numpy(cfg, _unflatten(tree), "cpu")
        places = tree_placements(params, mesh)
        dp = tree_map(lambda t, p: distribute_tensor(t, mesh, list(p)),
                      params, places)
        tok_pl = list(placements(batch_pspec(inp["tokens"].shape, mesh),
                                 mesh))
        tokens = distribute_tensor(torch.from_numpy(inp["tokens"]), mesh,
                                   tok_pl)
        labels = distribute_tensor(torch.from_numpy(inp["labels"]), mesh,
                                   tok_pl)
        with torch.no_grad():
            logits, aux = forward(cfg, dp, tokens, mesh_axes=MESH_AXES_SINGLE)
        out[f"{arch}/placements"] = np.array(str(logits.placements))
        out[f"{arch}/logits"] = logits.full_tensor().numpy()
        out[f"{arch}/aux"] = (aux.full_tensor() if isinstance(aux, DTensor)
                              else aux).numpy()
        live = tree_map(lambda t: t.detach().requires_grad_(True), dp)
        loss = lm_loss(cfg, live, tokens, labels, mesh_axes=MESH_AXES_SINGLE)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        out[f"{arch}/loss"] = loss.full_tensor().detach().numpy()
        for i, g in enumerate(grads):
            out[f"{arch}/grad/{i}"] = g.full_tensor().numpy()
        _, scales, _ = compress_grads(list(grads), ef_init(list(grads)))
        for i, sc in enumerate(scales):
            out[f"{arch}/scale/{i}"] = sc.full_tensor().numpy()
    out.update(_decode(d, mesh))
    if rank == 0:
        np.savez(f"{d}/port.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
""")

# The rank script's helper: the reference's params tree from its flattened
# npz ("layers/0/attn/wq" keys).
_UNFLATTEN = textwrap.dedent("""
    def _unflatten(npz):
        root = {}
        for key in npz.files:
            *path, leaf = key.split("/")
            node = root
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]

        def lists(n):
            if isinstance(n, dict):
                if n and all(k.isdigit() for k in n):
                    return [lists(n[str(i)]) for i in range(len(n))]
                return {k: lists(v) for k, v in n.items()}
            return n
        return lists(root)
""")


# The rank script's decode: `decode_step` on caches placed by
# `state_pspecs`, params replicated ("rep") or by `tree_placements`
# ("tree"); each step's logits and the last state, gathered.
_DECODE = textwrap.dedent("""
    def _decode(d, mesh):
        from torch.distributed.tensor import Replicate
        from repro_torch.launch.sharding import state_pspecs
        from repro_torch.models.transformer import (decode_step,
                                                    init_decode_state)
        out = {}
        for arch in DECODE_ARCHS:
            cfg = get_config(arch, smoke=True)
            params = params_from_numpy(
                cfg, _unflatten(np.load(f"{d}/{arch}_params.npz")), "cpu")
            toks = torch.from_numpy(np.load(f"{d}/{arch}_decode.npy"))
            for mode in ("rep", "tree"):
                places = (tree_map(lambda _: (Replicate(), Replicate()),
                                   params) if mode == "rep"
                          else tree_placements(params, mesh))
                dp = tree_map(lambda t, p: distribute_tensor(t, mesh,
                                                             list(p)),
                              params, places)
                state = init_decode_state(cfg, toks.shape[0], DECODE_LEN,
                                          device="cpu")
                specs = state_pspecs(state, mesh)
                state["layers"] = [
                    {k: distribute_tensor(t, mesh,
                                          list(placements(sp[k], mesh)))
                     for k, t in layer.items()}
                    for layer, sp in zip(state["layers"], specs["layers"])]
                tok_pl = list(placements(
                    batch_pspec((toks.shape[0], 1), mesh), mesh))
                logits = []
                with torch.no_grad():
                    for i in range(toks.shape[1]):
                        tok = distribute_tensor(
                            toks[:, i:i + 1].contiguous(), mesh, tok_pl)
                        lg, state = decode_step(cfg, dp, tok, state)
                        logits.append(lg.full_tensor().numpy())
                out[f"{arch}/{mode}/logits"] = np.concatenate(logits, 1)
                for li, layer in enumerate(state["layers"]):
                    for k, t in layer.items():
                        out[f"{arch}/{mode}/state/{li}/{k}"] = (
                            t.full_tensor().numpy())
            out.update(_decode_stacked(cfg, arch, params, toks, mesh))
        out.update(_decode_recurrent_stack(mesh))
        out.update(_mlstm_sharded(mesh))
        out.update(_fsdp_stacked(mesh))
        return out

    def _mlstm_sharded(mesh):
        # `mlstm_step` on states placed by `state_pspecs`, unstacked (heads
        # over "model") and as a stacked leaf's layer (the key dim over
        # "model", the partial sums all-reduced), beside the plain step on
        # this rank's plain tensors; x and the params replicated.
        from torch.distributed.tensor import Replicate
        from repro_torch.launch.sharding import state_pspecs
        from repro_torch.models import recurrent as R
        from repro_torch.models.transformer import LayerSlice
        rng = np.random.default_rng(13)
        b, h, hd = 4, 4, 16
        d = h * hd
        shapes = dict(wq=(d, d), wk=(d, d), wv=(d, d), wi=(d, h), wf=(d, h),
                      gn=(d,), wo=(d, d))
        p = {k: torch.from_numpy(0.2 * rng.standard_normal(sh).astype(
            np.float32)) for k, sh in shapes.items()}
        rp = {k: distribute_tensor(t, mesh, [Replicate()] * 2)
              for k, t in p.items()}
        xs = torch.from_numpy(rng.standard_normal((6, b, 1, d)).astype(
            np.float32))
        out = {}
        for layout in ("flat", "stacked"):
            plain = R.mlstm_init_state(b, h, hd)
            if layout == "flat":
                specs = state_pspecs(plain, mesh)
                st = {k: distribute_tensor(t, mesh,
                                           list(placements(specs[k], mesh)))
                      for k, t in plain.items()}
            else:
                specs = state_pspecs({"s": {k: t[None] for k, t in
                                            plain.items()}}, mesh)["s"]
                st = {k: LayerSlice(distribute_tensor(
                    t[None].clone(), mesh, list(placements(specs[k], mesh))),
                    (0,)).read() for k, t in plain.items()}
            ys, want = [], []
            with torch.no_grad():
                for x in xs:
                    y, st = R.mlstm_step(
                        rp, distribute_tensor(x, mesh, [Replicate()] * 2), st,
                        h)
                    ys.append(y.full_tensor().numpy())
                    y, plain = R.mlstm_step(p, x, plain, h)
                    want.append(y.numpy())
            out[f"mlstm/{layout}/placements"] = np.array(str(
                st["c"].placements))
            out[f"mlstm/{layout}/y"] = np.stack(ys)
            out[f"mlstm/{layout}/plain/y"] = np.stack(want)
            for k in st:
                out[f"mlstm/{layout}/{k}"] = st[k].full_tensor().numpy()
                out[f"mlstm/{layout}/plain/{k}"] = plain[k].numpy()
        return out

    def _fsdp_stacked(mesh):
        # Yi-6B SMOKE at 4 layers, stacked, its params placed by
        # `tree_placements` with FSDP on (each stacked leaf's layer dim over
        # "data"): `forward_scan` and `lm_loss_scan` with the hints, and the
        # loss's gradients, beside the same on this rank's plain tensors.
        import dataclasses
        from repro_torch.models.stacked import (forward_scan, lm_loss_scan,
                                                stack_params)
        from repro_torch.models.transformer import init_params
        cfg = dataclasses.replace(get_config("yi_6b", smoke=True),
                                  n_layers=4)
        params = stack_params(cfg, init_params(
            cfg, torch.Generator().manual_seed(5), device="cpu"))
        places = tree_placements(params, mesh, fsdp=True)
        dp = tree_map(lambda t, p: distribute_tensor(t, mesh, list(p)),
                      params, places)
        rng = np.random.default_rng(17)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, 16)))
        labels = torch.roll(tokens, -1, -1)
        tok_pl = list(placements(batch_pspec(tokens.shape, mesh), mesh))
        dt, dl = (distribute_tensor(t, mesh, tok_pl) for t in (tokens,
                                                               labels))
        out = {"fsdp/placements": np.array(str(
            dp["scan"][0]["attn"]["wq"].placements))}
        with torch.no_grad():
            out["fsdp/logits"] = forward_scan(
                cfg, dp, dt, mesh_axes=MESH_AXES_SINGLE)[0].full_tensor(
                ).numpy()
            out["fsdp/plain/logits"] = forward_scan(cfg, params,
                                                    tokens)[0].numpy()
        for name, tree, args in (("fsdp", dp, (dt, dl)),
                                 ("fsdp/plain", params, (tokens, labels))):
            live = tree_map(lambda t: t.detach().requires_grad_(True), tree)
            loss = lm_loss_scan(cfg, live, *args, mesh_axes=(
                MESH_AXES_SINGLE if tree is dp else None))
            grads = torch.autograd.grad(loss, tree_leaves(live))
            full = [g.full_tensor() if tree is dp else g for g in grads]
            out[f"{name}/loss"] = (loss.full_tensor() if tree is dp
                                   else loss).detach().numpy()
            for i, g in enumerate(full):
                out[f"{name}/grad/{i}"] = g.numpy()
        return out

    def _decode_recurrent_stack(mesh):
        # xLSTM SMOKE at 4 layers, two (sLSTM, mLSTM) units, so that
        # `state_pspecs` shards the stacked recurrent states' layer dim
        # over "data": `decode_step_scan` with params replicated reads each
        # layer's state from the rank that holds it (`LayerSlice.read`),
        # beside the plain `decode_step` on this rank's plain tensors.
        import dataclasses
        from torch.distributed.tensor import Replicate
        from repro_torch.launch.sharding import state_pspecs
        from repro_torch.models.stacked import (decode_step_scan,
                                                init_decode_state_stacked,
                                                stack_params)
        from repro_torch.models.transformer import (decode_step,
                                                    init_decode_state,
                                                    init_params)
        cfg = dataclasses.replace(get_config("xlstm_125m", smoke=True),
                                  n_layers=4)
        params = init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, size=(4, 6), dtype=np.int64))
        sp = tree_map(lambda t: distribute_tensor(t, mesh, [Replicate()] * 2),
                      stack_params(cfg, params))
        state = init_decode_state_stacked(cfg, 4, 8, device="cpu")
        specs = state_pspecs(state, mesh)
        state["scan"] = [
            {k: distribute_tensor(t, mesh, list(placements(s[k], mesh)))
             for k, t in unit.items()}
            for unit, s in zip(state["scan"], specs["scan"])]
        plain = init_decode_state(cfg, 4, 8, device="cpu")
        tok_pl = list(placements(batch_pspec((4, 1), mesh), mesh))
        got, want = [], []
        with torch.no_grad():
            for i in range(toks.shape[1]):
                tok = toks[:, i:i + 1].contiguous()
                lg, state = decode_step_scan(
                    cfg, sp, distribute_tensor(tok, mesh, tok_pl), state)
                got.append(lg.full_tensor().numpy())
                lg, plain = decode_step(cfg, params, tok, plain)
                want.append(lg.numpy())
        return {"xlstm4/stacked/logits": np.concatenate(got, 1),
                "xlstm4/plain/logits": np.concatenate(want, 1),
                "xlstm4/stacked/placements": np.array(str(
                    state["scan"][1]["c"].placements)),
                "xlstm4/stacked/c": state["scan"][1]["c"].full_tensor()
                .numpy(),
                "xlstm4/plain/c": np.stack([plain["layers"][i]["c"].numpy()
                                            for i in (1, 3)])}

    def _decode_stacked(cfg, arch, params, toks, mesh):
        # `decode_step_scan` on the stacked state placed by `state_pspecs`:
        # the layer dim over "data" where it divides, the head dim over
        # "model"; params replicated.
        from torch.distributed.tensor import Replicate
        from repro_torch.launch.sharding import state_pspecs
        from repro_torch.models.stacked import (decode_step_scan,
                                                init_decode_state_stacked,
                                                stack_params)
        sp = tree_map(lambda t: distribute_tensor(t, mesh, [Replicate()] * 2),
                      stack_params(cfg, params))
        state = init_decode_state_stacked(cfg, toks.shape[0], DECODE_LEN,
                                          device="cpu")
        specs = state_pspecs(state, mesh)
        for part in ("scan", "rest"):
            state[part] = [
                {k: distribute_tensor(t, mesh, list(placements(s[k], mesh)))
                 for k, t in unit.items()}
                for unit, s in zip(state[part], specs[part])]
        tok_pl = list(placements(batch_pspec((toks.shape[0], 1), mesh),
                                 mesh))
        logits = []
        with torch.no_grad():
            for i in range(toks.shape[1]):
                tok = distribute_tensor(toks[:, i:i + 1].contiguous(), mesh,
                                        tok_pl)
                lg, state = decode_step_scan(cfg, sp, tok, state)
                logits.append(lg.full_tensor().numpy())
        out = {f"{arch}/stacked/logits": np.concatenate(logits, 1),
               f"{arch}/stacked/placements": np.array(str(
                   state["scan"][0]["k"].placements))}
        for j, unit in enumerate(state["scan"]):
            for k, t in unit.items():
                out[f"{arch}/stacked/scan/{j}/{k}"] = t.full_tensor().numpy()
        return out
""")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flatten(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flatten(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _single_decode(arch, toks):
    """The single process's plain `decode_step` on the same params and
    tokens: (each step's logits (B, steps, V), the last state's layers)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    tree = jax.tree_util.tree_map(np.asarray, r_tf.init_params(
        r_configs.get_config(arch, smoke=True), jax.random.PRNGKey(5)))
    params = p_tf.params_from_numpy(cfg, tree, "cpu")
    state = p_tf.init_decode_state(cfg, toks.shape[0], DECODE_LEN,
                                   device="cpu")
    logits = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lg, state = p_tf.decode_step(
                cfg, params, torch.from_numpy(toks[:, i:i + 1]).contiguous(),
                state)
            logits.append(lg.numpy())
    return np.concatenate(logits, 1), state["layers"]


def _single(arch, inp):
    """The single-process port on plain tensors: logits, aux, loss and the
    gradients in `tree_leaves` order."""
    from repro_torch.configs import get_config
    from repro_torch.train.optim import tree_leaves, tree_map
    cfg = get_config(arch, smoke=True)
    tree = jax.tree_util.tree_map(np.asarray, r_tf.init_params(
        r_configs.get_config(arch, smoke=True), jax.random.PRNGKey(5)))
    params = p_tf.params_from_numpy(cfg, tree, "cpu")
    tokens = torch.from_numpy(inp["tokens"])
    labels = torch.from_numpy(inp["labels"])
    with torch.no_grad():
        logits, aux = p_tf.forward(cfg, params, tokens)
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = p_tf.lm_loss(cfg, live, tokens, labels)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return logits.numpy(), aux.numpy(), loss.detach().numpy(), \
        [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's results, the 8 ranks' and the single process's,
    from one run of each."""
    d = tmp_path_factory.mktemp("hints")
    inputs = {}
    for arch in ARCHS:
        r_cfg = r_configs.get_config(arch, smoke=True)
        tokens = np.random.default_rng(7).integers(
            0, r_cfg.vocab, size=(B, S), dtype=np.int32)
        inputs[arch] = {"tokens": tokens,
                        "labels": np.roll(tokens, -1, axis=-1)}
        np.savez(d / f"{arch}.npz", **inputs[arch])
    decode_toks = {}
    for arch in dict.fromkeys(ARCHS + DECODE_ARCHS):
        r_cfg = r_configs.get_config(arch, smoke=True)
        np.savez(d / f"{arch}_params.npz", **_flatten(jax.tree_util.tree_map(
            np.asarray, r_tf.init_params(r_cfg, jax.random.PRNGKey(5)))))
        if arch in DECODE_ARCHS:
            decode_toks[arch] = np.random.default_rng(11).integers(
                0, r_cfg.vocab, size=(B, DECODE_STEPS), dtype=np.int64)
            np.save(d / f"{arch}_decode.npy", decode_toks[arch])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    rank = (f"DECODE_ARCHS = {DECODE_ARCHS!r}\nDECODE_LEN = {DECODE_LEN}\n"
            + _UNFLATTEN + _DECODE + _RANK)
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d),
                               *ARCHS], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", rank, str(d), str(r),
                                *ARCHS], env=env, cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for r in range(8)]
    try:
        single = {arch: _single(arch, inputs[arch]) for arch in ARCHS}
        single.update({f"{arch}/decode": _single_decode(arch, toks)
                       for arch, toks in decode_toks.items()})
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return (dict(np.load(d / "reference.npz")), dict(np.load(d / "port.npz")),
            single)


def _ref_grads(ref, arch):
    """The reference's gradients in the port's `tree_leaves` order (the
    reference's keystr paths sorted as the port's dicts are walked)."""
    from repro_torch.configs import get_config
    from repro_torch.train.optim import tree_leaves
    cfg = get_config(arch, smoke=True)
    order = tree_leaves(p_tf._map_spec(
        p_tf._param_spec(cfg), None,
        lambda path, leaf, _: "".join(
            f"[{p}]" if p.isdigit() else f"['{p}']"
            for p in path.strip("/").replace("[", "/").replace("]", "")
            .split("/") if p)))
    return [ref[f"{arch}/grad/{key}"] for key in order]


@pytest.mark.parametrize("arch", ARCHS)
def test_hinted_forward_matches_single_process_and_reference(run, arch):
    ref, port, single = run
    assert str(port[f"{arch}/placements"]) == \
        "(Shard(dim=0), Shard(dim=2))"
    for want in (single[arch][0], ref[f"{arch}/logits"]):
        np.testing.assert_allclose(port[f"{arch}/logits"], want,
                                   atol=LOGIT_TOL)
    for want in (single[arch][1], ref[f"{arch}/aux"]):
        assert abs(float(port[f"{arch}/aux"]) - float(want)) <= LOSS_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_hinted_loss_and_gradients_match(run, arch):
    ref, port, single = run
    for want in (single[arch][2], ref[f"{arch}/loss"]):
        assert abs(float(port[f"{arch}/loss"]) - float(want)) <= LOSS_TOL
    ref_grads = _ref_grads(ref, arch)
    assert len(ref_grads) == len(single[arch][3])
    for i, (s_g, r_g) in enumerate(zip(single[arch][3], ref_grads)):
        got = port[f"{arch}/grad/{i}"]
        for want in (s_g, r_g):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert got.shape == want.shape
            assert float(np.abs(got - want).max()) <= LM_GRAD_TOL * scale, i


@pytest.mark.parametrize("arch", ARCHS)
def test_hinted_int8_scales_span_the_whole_gradient(run, arch):
    """`compress_grads` on the ranks' DTensor gradients takes each scale
    over the whole logical gradient (max |g| / 127 + 1e-12, reduced over
    the shards), as the reference's is under GSPMD: the single-process
    scales within LM_GRAD_TOL."""
    from repro_torch.train.compression import compress_grads, ef_init
    _, port, single = run
    grads = [torch.from_numpy(g) for g in single[arch][3]]
    _, scales, _ = compress_grads(grads, ef_init(grads))
    for i, want in enumerate(scales):
        got = float(port[f"{arch}/scale/{i}"])
        assert abs(got - float(want)) <= LM_GRAD_TOL * float(want), i


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_hinted_decode_on_sharded_caches_is_the_plain_decode(run, arch):
    """Replicated DTensor params, caches placed by `state_pspecs`: every
    step's logits and the last caches (and `slot_pos`) bit for bit."""
    _, port, single = run
    logits, layers = single[f"{arch}/decode"]
    np.testing.assert_array_equal(port[f"{arch}/rep/logits"], logits)
    assert len(layers) > 0
    for li, layer in enumerate(layers):
        for k, t in layer.items():
            np.testing.assert_array_equal(
                port[f"{arch}/rep/state/{li}/{k}"], t.numpy(), err_msg=k)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_hinted_decode_with_sharded_params_matches(run, arch):
    """Params placed by `tree_placements` as well: the row-parallel
    products sum their partial sums over the ranks, so the logits are
    held within LOGIT_TOL, not bit for bit."""
    _, port, single = run
    logits, _ = single[f"{arch}/decode"]
    np.testing.assert_allclose(port[f"{arch}/tree/logits"], logits,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_hinted_stacked_decode_on_head_dim_shards_matches(run, arch):
    """`decode_step_scan` on the stacked caches `state_pspecs` places (the
    head dim over "model", Yi-6B's two layers over "data"), so that each
    rank attends over a slice of the head dim and the partial scores are
    summed over "model": every step's logits within LOGIT_TOL of the
    plain step's, and each stacked cache leaf's layers the plain caches
    within the same."""
    from repro_torch.models.stacked import unit_kinds
    _, port, single = run
    logits, layers = single[f"{arch}/decode"]
    assert "Shard(dim=4)" in str(port[f"{arch}/stacked/placements"])
    np.testing.assert_allclose(port[f"{arch}/stacked/logits"], logits,
                               atol=LOGIT_TOL)
    from repro_torch.configs import get_config
    u = len(unit_kinds(get_config(arch, smoke=True)))
    for li, layer in enumerate(layers):
        for k, t in layer.items():
            got = port[f"{arch}/stacked/scan/{li % u}/{k}"][li // u]
            np.testing.assert_allclose(got, t.numpy(), atol=LOGIT_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("layout", ("flat", "stacked"))
def test_hinted_mlstm_step_on_sharded_states_matches(run, layout):
    """`mlstm_step` on states placed by `state_pspecs` (the stacked
    layout's c sharded along its key dim, so that each rank updates its
    shard and the partial numerator and denominator are summed over
    "model"): each step's output and the last c, n and m equal the plain
    step's within 1e-6 of each tensor's largest value (the sums are taken
    in another order)."""
    _, port, _ = run
    want_dim = "Shard(dim=3)" if layout == "stacked" else "Shard(dim=1)"
    assert want_dim in str(port[f"mlstm/{layout}/placements"])
    for k in ("y", "c", "n", "m"):
        got, want = port[f"mlstm/{layout}/{k}"], \
            port[f"mlstm/{layout}/plain/{k}"]
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= MLSTM_TOL * scale, k


def test_hinted_fsdp_stacked_forward_loss_and_gradients_match(run):
    """Stacked Yi-6B SMOKE at 4 layers, params placed with FSDP on (each
    layer read from the rank that holds it): `forward_scan`'s logits within
    LOGIT_TOL, `lm_loss_scan` within LOSS_TOL and its gradients within
    LM_GRAD_TOL of each tensor's largest value, against the plain calls."""
    _, port, _ = run
    assert "Shard(dim=0)" in str(port["fsdp/placements"])
    np.testing.assert_allclose(port["fsdp/logits"], port["fsdp/plain/logits"],
                               atol=LOGIT_TOL)
    assert abs(float(port["fsdp/loss"]) - float(port["fsdp/plain/loss"])) \
        <= LOSS_TOL
    n = len([k for k in port if k.startswith("fsdp/plain/grad/")])
    assert n > 0
    for i in range(n):
        got, want = port[f"fsdp/grad/{i}"], port[f"fsdp/plain/grad/{i}"]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= LM_GRAD_TOL * scale, i


def test_hinted_stacked_decode_reads_recurrent_states_from_their_rank(run):
    """xLSTM SMOKE at 4 layers, its stacked recurrent states' layer dim
    over "data": each layer's state is read from the rank that holds it
    and written back there, and every step's logits and the last mLSTM
    states equal the plain `decode_step`'s within LOGIT_TOL."""
    _, port, _ = run
    assert "Shard(dim=0)" in str(port["xlstm4/stacked/placements"])
    np.testing.assert_allclose(port["xlstm4/stacked/logits"],
                               port["xlstm4/plain/logits"], atol=LOGIT_TOL)
    np.testing.assert_allclose(port["xlstm4/stacked/c"],
                               port["xlstm4/plain/c"], atol=LOGIT_TOL)
