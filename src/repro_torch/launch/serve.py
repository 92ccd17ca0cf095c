"""Serving launcher: batched greedy LM decoding with a KV cache, or GCN
serving.

`serve(cfg, params, prompts, steps)` prefills the prompts token by token
through `decode_step`, then decodes `steps` tokens greedily, on the device
the params lie on.

`serve_gcn` registers two scaled paper graphs, queues `batch` requests per
graph per epoch and drains them, printing per-epoch uploaded vs cache-hit
wire bytes. It draws its graphs and requests from the same seeded streams
as `repro.launch.serve.serve_gcn`. With `--workers 2 --cache-shards 4
--calibrate` it serves from replicated workers that share a cache
directory, each over a four-shard cache, with the cost model refitted from
every batch's latencies. With `--autotune` each graph's schedule is
searched and installed after the first epoch.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch yi_6b [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode gcn [--passes] \
        [--workers 2] [--cache-shards 4] [--calibrate] [--autotune] \
        [--device cpu]

`serve_continuous` replays a seeded Poisson or bursty arrival trace over
the same two graphs through the continuous-batching loop on a virtual
clock (`--mode continuous --trace {poisson,bursty} --requests N`).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode continuous \
        [--trace bursty] [--requests 24] [--device cpu]

`--mode lm`, the default as in the reference, serves the arch's SMOKE
config and needs `--arch` (`yi_6b`, `yi_9b`, `deepseek_7b`, `gemma2_27b`,
whose local layers decode into ring caches of min(window, prompt + steps
+ 1) slots, the MoE archs `mixtral_8x22b` and `kimi_k2_1t_a32b`, the
recurrent archs `xlstm_125m` and `recurrentgemma_2b`, whose recurrent
layers step an O(1) state, `qwen2_vl_72b`, which decodes as the
reference does, with plain RoPE at the index and no vision input, or the
encoder-decoder `seamless_m4t_medium`, whose encoder runs once over f32
zero frames as in the reference); the full config is
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
    production variant); then each step feeds back the argmax. An
    encoder-decoder config encodes once first, as the reference does, over
    f32 zero frames (B, audio_frames, d_model) (the reference's stub of
    an audio input), and every step attends over that `enc_out`. Runs
    under `torch.inference_mode()`; the tokens stay on the device until
    the end.
    """
    from repro_torch.models import decode_step, encode, init_decode_state

    b, s0 = prompts.shape
    if s0 < 1:
        raise ValueError("serve needs at least one prompt token")
    device = params["embed"].device
    with torch.inference_mode():
        state = init_decode_state(cfg, b, max_len=s0 + steps + 1,
                                  device=device)
        enc_out = None
        if cfg.is_enc_dec:
            audio = torch.zeros((b, cfg.audio_frames, cfg.d_model),
                                dtype=torch.float32, device=device)
            enc_out = encode(cfg, params, audio)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=device)
        for t in range(s0):
            logits, state = decode_step(cfg, params, toks[:, t:t + 1], state,
                                        enc_out=enc_out)
        out = []
        tok = torch.argmax(logits, dim=-1)
        for _ in range(steps):
            out.append(tok[:, 0])
            logits, state = decode_step(cfg, params, tok, state,
                                        enc_out=enc_out)
            tok = torch.argmax(logits, dim=-1)
        if not out:
            return np.zeros((b, 0), np.int32)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def _paper_graphs(scale: float) -> tuple:
    """The launchers' two graphs, socLJ1 and rUSA at `scale` (seeds 0 and
    1, as the reference draws them), and their shared device budget."""
    from repro_torch.data import (
        SUITESPARSE_SPECS, generate_graph, normalized_adjacency, scaled_spec,
    )

    graphs = {
        name: normalized_adjacency(generate_graph(
            scaled_spec(SUITESPARSE_SPECS[name], scale), seed=i))
        for i, name in enumerate(("socLJ1", "rUSA"))
    }
    return graphs, _paper_budget(graphs)


def _paper_budget(graphs: dict) -> int:
    """The launchers' shared device budget for `graphs`: feasible for the
    engine's pinned plan width (64), small enough that streaming still
    splits into several segments per graph."""
    from repro_torch.core import plan_memory_dense_features

    return max(
        int(est.m_b + est.m_c + 0.6 * a.nbytes())
        for a in graphs.values()
        for est in [plan_memory_dense_features(a, a.n_rows, 64,
                                               float("inf"))])


def serve_gcn(scale: float = 1e-4, batch: int = 4, epochs: int = 2,
              cache: bool = True, feature_dim: int = 16, seed: int = 0,
              cache_shards: int = 1, workers: int = 1,
              passes: bool = False, calibrate: bool = False,
              autotune: bool = False, summary_out=None,
              device: str = "cuda"):
    """Drive the multi-graph GCN serving engine on `device`; returns the
    per-epoch reports.

    The signature is `repro.launch.serve.serve_gcn`'s plus `device`.
    `cache_shards > 1` partitions each worker's cache device tier across
    shards (remote hits ride ICI); `workers > 1` runs replicated engines
    against the same graphs with a shared `CacheDirectory`, so one worker's
    demoted bricks serve the others' misses. With one worker the reports
    are a flat per-epoch list; with several, a list of per-epoch lists,
    one report per worker.

    `passes` routes every batch through the plan-rewrite pipeline
    (core.passes): shard-aware brick placement, transfer coalescing and
    EDF request ordering. `calibrate` attaches a `CostCalibrator` to every
    worker: each batch's `RequestLatency` stream refits the cost model,
    so later epochs price against the calibrated spec. `autotune` searches
    and installs every worker's schedule per graph after the first epoch
    (`ServingEngine.autotune`). A `summary_out` dict receives the
    per-epoch (calibrated, uncalibrated) mean |error| and worker 0's
    installed schedules, described.
    """
    from repro_torch.core import (
        CostCalibrator, EDFOrderingPass, ShardPlacementPass,
        TransferCoalescingPass,
    )
    from repro_torch.io import CacheDirectory
    from repro_torch.runtime import (
        EngineConfig, InferenceRequest, ServingEngine,
    )

    rng = np.random.default_rng(seed)
    graphs, budget = _paper_graphs(scale)
    directory = CacheDirectory() if workers > 1 else None
    plan_passes = ([ShardPlacementPass(), TransferCoalescingPass(),
                    EDFOrderingPass()] if passes else None)
    engines = []
    for wid in range(workers):
        eng = ServingEngine(
            EngineConfig(device_budget_bytes=budget, cache_enabled=cache,
                         cache_shards=cache_shards, worker_id=wid,
                         plan_passes=plan_passes, device=device,
                         calibrator=CostCalibrator() if calibrate else None),
            directory=directory)
        for name, a in graphs.items():
            eng.register_graph(name, a)
        engines.append(eng)

    # Fixed-spec baseline predictions for the calibration comparison: one
    # template request per graph, priced against the uncalibrated
    # tier_spec (spec= bypasses the calibrated memo).
    uncal_cost = {}
    if calibrate:
        for name, a in graphs.items():
            h0 = np.zeros((a.n_rows, feature_dim), np.float32)
            w0 = [np.zeros((feature_dim, feature_dim), np.float32)]
            uncal_cost[name] = engines[0].estimate_request_cost(
                InferenceRequest(name, h0, w0),
                spec=engines[0].config.tier_spec)

    epoch_errors = []  # (calibrated mean |err|, uncalibrated mean |err|)
    reports = []
    for epoch in range(epochs):
        epoch_reports = []
        for eng in engines:
            for name, a in graphs.items():
                for _ in range(batch):
                    h = rng.standard_normal(
                        (a.n_rows, feature_dim)).astype(np.float32)
                    w = [rng.standard_normal(
                        (feature_dim, feature_dim)).astype(np.float32)]
                    eng.submit(InferenceRequest(name, h, w))
            epoch_reports.append(eng.run_batch())
        if calibrate:
            lats = [lt for r in epoch_reports for lt in r.request_latency]
            if lats:
                epoch_errors.append((
                    sum(abs(lt.error_s) for lt in lats) / len(lats),
                    sum(abs(lt.processing_s - uncal_cost[lt.graph])
                        for lt in lats) / len(lats)))
        if autotune and epoch == 0:
            for eng in engines:
                for name in graphs:
                    eng.autotune(name, install=True)
        reports.append(epoch_reports[0] if workers == 1 else epoch_reports)
    if summary_out is not None:
        summary_out["epoch_errors"] = epoch_errors
        summary_out["installed_schedules"] = {
            name: tuned.describe()
            for name, tuned in engines[0].installed_schedules.items()}
    return reports


def serve_continuous(scale: float = 1e-4, trace: str = "poisson",
                     requests: int = 24, seed: int = 0,
                     feature_dim: int = 16, device: str = "cuda"):
    """Replay an arrival trace through the continuous step loop on
    `device`.

    Builds the same two-graph engine as `serve_gcn` but on a shared
    `VirtualClock`, generates a Poisson or Gamma-modulated bursty trace
    whose rate and deadlines are quoted in units of one modeled pass,
    and streams it through a `ContinuousServer`. Returns the
    `(ServeReport, summary_dict)` pair. The signature is
    `repro.launch.serve.serve_continuous`'s plus `device`; the virtual
    timeline and the byte counters do not depend on the device."""
    from repro_torch.core import EDFOrderingPass
    from repro_torch.runtime import (
        ContinuousServer, EngineConfig, InferenceRequest, ServingEngine,
        VirtualClock, bursty_trace, poisson_trace, replay_continuous,
        summarize,
    )

    rng = np.random.default_rng(seed)
    graphs, budget = _paper_graphs(scale)
    clock = VirtualClock()
    eng = ServingEngine(EngineConfig(
        device_budget_bytes=budget, clock=clock, device=device,
        plan_passes=[EDFOrderingPass(clock=clock)]))
    for name, a in graphs.items():
        eng.register_graph(name, a)

    feats = {name: rng.standard_normal(
        (a.n_rows, feature_dim)).astype(np.float32)
        for name, a in graphs.items()}
    weights = rng.standard_normal(
        (feature_dim, feature_dim)).astype(np.float32)
    unit = eng.estimate_request_cost(
        InferenceRequest("socLJ1", feats["socLJ1"], [weights]))
    maker = poisson_trace if trace == "poisson" else bursty_trace
    rate_key = "rate_hz" if trace == "poisson" else "base_rate_hz"
    arrivals = maker(n=requests, graphs=sorted(graphs), seed=seed,
                     feature_dim=feature_dim, deadline_s=3.0 * unit,
                     **{rate_key: 1.5 / unit})

    def make_request(arr):
        return InferenceRequest(arr.graph, feats[arr.graph], [weights],
                                deadline_s=arr.deadline_s)

    report = replay_continuous(ContinuousServer(eng), arrivals, make_request)
    return report, summarize(report)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "gcn", "continuous"),
                    default="lm")
    ap.add_argument("--arch", help="lm mode: any arch id of the registry, "
                    "e.g. yi_6b or seamless_m4t_medium")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the tiered segment cache")
    ap.add_argument("--cache-shards", type=int, default=1,
                    help="gcn mode: partition the cache device tier over "
                         "this many shards (remote hits ride ICI)")
    ap.add_argument("--workers", type=int, default=1,
                    help="gcn mode: replicated serving workers sharing a "
                         "CacheDirectory (dedups demotion copies)")
    ap.add_argument("--passes", action="store_true",
                    help="gcn mode: route stream plans through the rewrite "
                         "passes (shard placement, transfer coalescing, "
                         "EDF ordering)")
    ap.add_argument("--calibrate", action="store_true",
                    help="gcn mode: fit the cost model online from each "
                         "batch's latency stream and reprice against it")
    ap.add_argument("--autotune", action="store_true",
                    help="gcn mode: autotune and install the plan schedule "
                         "per graph after the first epoch")
    ap.add_argument("--trace", choices=("poisson", "bursty"),
                    default="poisson",
                    help="continuous mode: arrival process to replay")
    ap.add_argument("--requests", type=int, default=24,
                    help="continuous mode: number of arrivals in the trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.mode == "continuous":
        _, summary = serve_continuous(trace=args.trace,
                                      requests=args.requests,
                                      seed=args.seed, device=args.device)
        print(f"{args.trace} trace: {summary['served']}/{summary['offered']} "
              f"served in {summary['groups_served']} groups, "
              f"{summary['on_time']} on time "
              f"(miss rate {summary['deadline_miss_rate']:.0%}); "
              f"p50 {summary['p50_latency_s']*1e3:.2f} ms, "
              f"p99 {summary['p99_latency_s']*1e3:.2f} ms, "
              f"goodput {summary['goodput_rps']:.1f} req/s; "
              f"uploaded {summary['uploaded_bytes']} B, "
              f"cache-hit {summary['cache_hit_bytes']} B "
              f"on {args.device}")
        return

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

    summary = {}
    reports = serve_gcn(batch=args.batch, epochs=args.epochs,
                        cache=not args.no_cache, seed=args.seed,
                        cache_shards=args.cache_shards,
                        workers=args.workers, passes=args.passes,
                        calibrate=args.calibrate, autotune=args.autotune,
                        summary_out=summary,
                        device=args.device)
    for e, rep in enumerate(reports):
        for wid, r in enumerate(rep if isinstance(rep, list) else [rep]):
            lat = r.request_latency
            err = (sum(abs(lt.error_s) for lt in lat) / len(lat)
                   if lat else 0.0)
            print(f"epoch {e} worker {wid}: {len(r.results)} requests, "
                  f"{r.aggregation_passes} streamed passes, "
                  f"uploaded {r.uploaded_bytes} B, "
                  f"cache-hit {r.cache_hit_bytes} B "
                  f"(promoted {r.promoted_bytes} B, "
                  f"ici {r.ici_bytes} B, "
                  f"peer-served {r.directory_hit_bytes} B, "
                  f"dup-avoided {r.duplicate_avoided_bytes} B, "
                  f"hit rate {r.hit_rate:.0%}) in {r.wall_seconds:.2f}s "
                  f"on {args.device}; "
                  f"mean |predicted-actual| {err*1e3:.2f} ms")
    for e, (cal_err, uncal_err) in enumerate(summary["epoch_errors"]):
        print(f"epoch {e}: calibrated mean |err| {cal_err*1e3:.2f} ms "
              f"vs uncalibrated {uncal_err*1e3:.2f} ms")
    for desc in summary["installed_schedules"].values():
        print(f"installed {desc}")


if __name__ == "__main__":
    main()
