"""How far a recurrent arch's bf16 teacher-forced decode lies from its own
forward, in the JAX package and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/recurrent_bf16_gap.py \
        [--arch xlstm_125m] [--layers 12] [--vocab 0] [--tokens 128] \
        [--seed 0]

The reference's `init_params` draws the weights of the arch's CONFIG
(bf16; cut to `--layers`, and to a vocabulary of `--vocab` where it is
not 0), `params_from_numpy` carries them to the port,
and one sequence of `--tokens` ids from `--seed` goes through each
package's `forward` and its `decode_step` one token at a time. Prints one
JSON line: each gap as max |Δ| over the largest |logit| (the measure
chip_smoke.py's lm_serve-like phases hold to LM_BF16_TOL), over all
positions and at some, for the reference, the port, the port against the
reference, and each bf16 forward against the reference's float32 forward
of the same weights. Like the parity tests it imports both packages; it
runs on the CPU only (under a minute at the defaults; RecurrentGemma-2B
at full width wants a few layers and a cut vocabulary on a small host).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as r_configs
from repro.models import transformer as r_tf
from repro_torch.models import transformer as p_tf


def gap(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm_125m",
                    choices=("xlstm_125m", "recurrentgemma_2b"))
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = dataclasses.replace(r_configs.get_config(args.arch),
                              n_layers=args.layers)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab=args.vocab)
    params = r_tf.init_params(cfg, jax.random.PRNGKey(args.seed))
    p_cfg = p_tf.ArchConfig(**dataclasses.asdict(cfg))
    p_params = p_tf.params_from_numpy(
        p_cfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    s = args.tokens
    tokens = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, size=(1, s), dtype=np.int32)

    r_fwd = np.asarray(r_tf.forward(cfg, params, jnp.asarray(tokens))[0],
                       np.float32)
    step = jax.jit(lambda p, t, st: r_tf.decode_step(cfg, p, t, st))
    state, r_dec = r_tf.init_decode_state(cfg, 1, s + 1), []
    for t in range(s):
        logits, state = step(params, jnp.asarray(tokens[:, t:t + 1]), state)
        r_dec.append(np.asarray(logits[:, 0], np.float32))
    r_dec = np.stack(r_dec, 1)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    r_f32 = np.asarray(r_tf.forward(
        cfg32, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      params), jnp.asarray(tokens))[0])

    with torch.inference_mode():
        p_tok = torch.from_numpy(tokens).long()
        p_fwd = p_tf.forward(p_cfg, p_params, p_tok)[0].float().numpy()
        state, p_dec = p_tf.init_decode_state(p_cfg, 1, s + 1,
                                              device="cpu"), []
        for t in range(s):
            logits, state = p_tf.decode_step(p_cfg, p_params,
                                             p_tok[:, t:t + 1], state)
            p_dec.append(logits[:, 0].float().numpy())
    p_dec = np.stack(p_dec, 1)

    at = [t for t in (0, 1, 2, 4, 8, 16, 32, 64, s - 1) if t < s]
    print(json.dumps({
        "config": cfg.name, "layers": cfg.n_layers, "vocab": cfg.vocab,
        "dtype": cfg.dtype,
        "tokens": s, "seed": args.seed,
        "reference_decode_vs_forward": gap(r_dec, r_fwd),
        "port_decode_vs_forward": gap(p_dec, p_fwd),
        "port_vs_reference_forward": gap(p_fwd, r_fwd),
        "port_vs_reference_decode": gap(p_dec, r_dec),
        "reference_bf16_vs_f32_forward": gap(r_fwd, r_f32),
        "port_bf16_vs_reference_f32_forward": gap(p_fwd, r_f32),
        "by_position": {t: {"reference": gap(r_dec[:, t], r_fwd[:, t]),
                            "port": gap(p_dec[:, t], p_fwd[:, t])}
                        for t in at}}))


if __name__ == "__main__":
    main()
