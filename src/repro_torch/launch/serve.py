"""Serving launcher: batched greedy LM decoding with a KV cache, or GCN
serving.

`serve(cfg, params, prompts, steps)` prefills the prompts token by token
through `decode_step`, then decodes `steps` tokens greedily, on the device
the params lie on.

`serve_gcn` registers two scaled paper graphs, queues `batch` requests per
graph per epoch and drains them, printing per-epoch uploaded vs cache-hit
wire bytes. It draws its graphs and requests from the same seeded streams
as `repro.launch.serve.serve_gcn`.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch yi_6b [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode gcn [--device cpu]

`--mode lm`, the default as in the reference, serves the arch's SMOKE
config and needs `--arch`; the full config is
`serve(get_config(arch), init_params(...), ...)`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serve(cfg, params, prompts: np.ndarray, steps: int = 8) -> np.ndarray:
    """prompts (B, S0) int → generated tokens (B, steps) int32.

    The prefill is teacher-forced through `decode_step`, one token at a
    time, as in the reference (a chunked prefill through `forward` is the
    production variant); then each step feeds back the argmax. Runs under
    `torch.inference_mode()`; the tokens stay on the device until the end.
    """
    from repro_torch.models import decode_step, init_decode_state

    b, s0 = prompts.shape
    if s0 < 1:
        raise ValueError("serve needs at least one prompt token")
    device = params["embed"].device
    with torch.inference_mode():
        state = init_decode_state(cfg, b, max_len=s0 + steps + 1,
                                  device=device)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=device)
        for t in range(s0):
            logits, state = decode_step(cfg, params, toks[:, t:t + 1], state)
        out = []
        tok = torch.argmax(logits, dim=-1)
        for _ in range(steps):
            out.append(tok[:, 0])
            logits, state = decode_step(cfg, params, tok, state)
            tok = torch.argmax(logits, dim=-1)
        if not out:
            return np.zeros((b, 0), np.int32)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def serve_gcn(scale: float = 1e-4, batch: int = 4, epochs: int = 2,
              cache: bool = True, feature_dim: int = 16, seed: int = 0,
              cache_shards: int = 1, workers: int = 1,
              passes: bool = False, calibrate: bool = False,
              autotune: bool = False, summary_out=None,
              device: str = "cuda"):
    """Drive the multi-graph GCN serving engine on `device`; returns the
    per-epoch `BatchReport`s.

    The signature is `repro.launch.serve.serve_gcn`'s plus `device`. The
    features behind `cache_shards`, `workers`, `passes`, `calibrate` and
    `autotune` are not ported yet: any value but the default raises. A
    `summary_out` dict receives what the reference reports when they are
    off: no calibration errors and no installed schedules.
    """
    unported = {"cache_shards": cache_shards != 1, "workers": workers != 1,
                "passes": passes, "calibrate": calibrate,
                "autotune": autotune}
    asked = sorted(name for name, on in unported.items() if on)
    if asked:
        raise NotImplementedError(
            f"serve_gcn: {', '.join(asked)} not ported to repro_torch yet")
    from repro_torch.core import plan_memory_dense_features
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    rng = np.random.default_rng(seed)
    graphs = {
        name: normalized_adjacency(generate_graph(
            scaled_spec(SUITESPARSE_SPECS[name], scale), seed=i))
        for i, name in enumerate(("socLJ1", "rUSA"))
    }
    # Feasible for the engine's pinned plan width (64), small enough that
    # streaming still splits into several segments per graph.
    budget = max(
        int(est.m_b + est.m_c + 0.6 * a.nbytes())
        for a in graphs.values()
        for est in [plan_memory_dense_features(a, a.n_rows, 64,
                                               float("inf"))])
    eng = ServingEngine(EngineConfig(device_budget_bytes=budget,
                                     cache_enabled=cache, device=device))
    for name, a in graphs.items():
        eng.register_graph(name, a)

    reports = []
    for _ in range(epochs):
        for name, a in graphs.items():
            for _ in range(batch):
                h = rng.standard_normal(
                    (a.n_rows, feature_dim)).astype(np.float32)
                w = [rng.standard_normal(
                    (feature_dim, feature_dim)).astype(np.float32)]
                eng.submit(InferenceRequest(name, h, w))
        reports.append(eng.run_batch())
    if summary_out is not None:
        summary_out["epoch_errors"] = []
        summary_out["installed_schedules"] = {}
    return reports


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "gcn"), default="lm")
    ap.add_argument("--arch", help="lm mode: arch id, e.g. yi_6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the tiered segment cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.mode == "lm":
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        if args.arch is None:
            ap.error("--arch is required in lm mode")
        cfg = get_config(args.arch, smoke=True)
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = init_params(cfg, gen, device=args.device)
        prompts = np.random.default_rng(args.seed).integers(
            0, cfg.vocab, size=(args.batch, args.prompt_len), dtype=np.int32)
        t0 = time.perf_counter()
        tokens = serve(cfg, params, prompts, steps=args.steps)
        dt = time.perf_counter() - t0
        print(f"generated {tokens.shape} in {dt:.2f}s "
              f"({args.batch * args.steps / dt:.1f} tok/s) on {args.device}")
        print(tokens)
        return

    reports = serve_gcn(batch=args.batch, epochs=args.epochs,
                        cache=not args.no_cache, seed=args.seed,
                        device=args.device)
    for e, r in enumerate(reports):
        lat = r.request_latency
        err = (sum(abs(lt.error_s) for lt in lat) / len(lat) if lat else 0.0)
        print(f"epoch {e}: {len(r.results)} requests, "
              f"{r.aggregation_passes} streamed passes, "
              f"uploaded {r.uploaded_bytes} B, "
              f"cache-hit {r.cache_hit_bytes} B "
              f"(promoted {r.promoted_bytes} B, hit rate {r.hit_rate:.0%}) "
              f"in {r.wall_seconds:.2f}s; "
              f"mean |predicted-actual| {err*1e3:.2f} ms")


if __name__ == "__main__":
    main()
