"""The run supervisor and the seekable token pipeline of the port, against
the JAX package's: the checks of tests/test_supervisor.py and
tests/test_checkpoint_runtime.py on `repro_torch.runtime` and
`repro_torch.data`, and the same answers as the reference for the same
inputs (restarts, backoff, `max_restarts`, the straggler EWMA,
`stream_deadline`, `ElasticMesh` shapes and local batches, and
`TokenPipeline` batches after a restart). `ElasticMesh.make` returns a
grid of `torch.device`s that `ShardedSegmentCache.from_mesh` reads."""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import repro.runtime as R
from repro.data import TokenPipeline as RPipeline
from repro.data import synthetic_token_batches as r_batches

from repro_torch.data import TokenPipeline, synthetic_token_batches
from repro_torch.io import ShardedSegmentCache
from repro_torch.runtime import (
    ElasticMesh, RunState, Supervisor, SupervisorConfig,
)


def _both(**kw):
    """(port Supervisor, reference Supervisor) on the same config."""
    return (Supervisor(SupervisorConfig(**kw)),
            R.Supervisor(R.SupervisorConfig(**kw)))


def _same_state(p, r):
    assert (p.step, p.restarts, p.straggler_events, p.step_time_ewma) == (
        r.step, r.restarts, r.straggler_events, r.step_time_ewma)


# ---- Supervisor.run: crash recovery ---------------------------------------

def test_run_completes_without_failures():
    for sup in _both(backoff_s=0.0):
        state = sup.run(lambda start: start + 10)
        assert (state.step, state.restarts) == (10, 0)


def test_run_restarts_on_recoverable_and_restores():
    """Two failures, each followed by restore(): every retry starts from
    the restored step, in both packages."""
    seen = []
    for sup in _both(max_restarts=3, backoff_s=0.0):
        calls, restores = [], []

        def body(start):
            calls.append(start)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return start + 1

        def restore():
            restores.append(True)
            return 7

        state = sup.run(body, restore=restore)
        assert (state.restarts, len(restores), calls, state.step) == (
            2, 2, [0, 7, 7], 8)
        seen.append(state)
    _same_state(*seen)


def test_run_without_restore_retries_from_same_step():
    for sup in _both(backoff_s=0.0):
        attempts = []

        def body(start):
            attempts.append(start)
            if len(attempts) == 1:
                raise RuntimeError("once")
            return start + 5

        state = sup.run(body)
        assert attempts == [0, 0] and state.step == 5


def test_run_exceeding_max_restarts_raises():
    for sup in _both(max_restarts=2, backoff_s=0.0):
        def body(start):
            raise RuntimeError("always")

        with pytest.raises(RuntimeError, match="max_restarts"):
            sup.run(body)
        assert sup.state.restarts == 3  # counted before the give-up check


def test_unrecoverable_exception_propagates_immediately():
    sup = Supervisor(SupervisorConfig(backoff_s=0.0),
                     recoverable=(ValueError,))

    def body(start):
        raise KeyError("not recoverable")

    with pytest.raises(KeyError):
        sup.run(body)
    assert sup.state.restarts == 0


def test_backoff_doubles_per_restart(monkeypatch):
    """The sleeps between restarts are backoff_s · 2^(k-1), as the
    reference's."""
    import time

    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    for sup in _both(max_restarts=4, backoff_s=0.25):
        calls = []

        def body(start):
            calls.append(start)
            if len(calls) < 4:
                raise RuntimeError("flaky")
            return start + 1

        sup.run(body)
    assert sleeps == [0.25, 0.5, 1.0] * 2


# ---- straggler tracking ----------------------------------------------------

def test_observe_step_first_sample_seeds_ewma():
    sup = Supervisor(SupervisorConfig())
    assert sup.observe_step(1.0) is False
    assert sup.state.step_time_ewma == 1.0


def test_observe_step_flags_stragglers_and_clamps_ewma():
    sup = Supervisor(SupervisorConfig(straggler_factor=3.0, ewma_alpha=0.5))
    sup.observe_step(1.0)
    assert sup.observe_step(10.0) is True        # > 3 × ewma
    assert sup.state.straggler_events == 1
    # the straggler was clamped to factor×ewma before entering the average
    assert sup.state.step_time_ewma == pytest.approx(0.5 * 1.0 + 0.5 * 3.0)
    assert sup.observe_step(2.1) is False        # normal step again


@pytest.mark.parametrize("factor,alpha", [(3.0, 0.2), (2.0, 0.5), (1.5, 0.1)])
def test_straggler_ewma_matches_reference(factor, alpha):
    """A seeded run of step times with spikes: the same straggler flags,
    events, EWMA and stream deadline after every step."""
    times = np.random.default_rng(int(factor * 10)).exponential(0.1, 60)
    times[::13] *= 12.0                           # spikes
    p, r = _both(straggler_factor=factor, ewma_alpha=alpha)
    assert p.stream_deadline() is None and r.stream_deadline() is None
    for t in times:
        assert p.observe_step(float(t)) == r.observe_step(float(t))
        _same_state(p.state, r.state)
        assert p.stream_deadline() == r.stream_deadline()
    assert p.state.straggler_events > 0


def test_stream_deadline_feeds_back_from_ewma():
    sup = Supervisor(SupervisorConfig(straggler_factor=2.5))
    assert sup.stream_deadline() is None         # no samples yet
    sup.observe_step(0.4)
    assert sup.stream_deadline() == pytest.approx(1.0)


def test_run_state_defaults():
    st = RunState()
    assert (st.step, st.restarts, st.straggler_events) == (0, 0, 0)


# ---- elastic mesh ----------------------------------------------------------

@pytest.mark.parametrize("mp", [1, 2, 4, 3])
def test_elastic_mesh_shapes_and_batches_match_reference(mp):
    p, r = ElasticMesh(model_parallel=mp), R.ElasticMesh(model_parallel=mp)
    for n in range(1, 17):
        assert p.shape_for(n) == r.shape_for(n)
        for gb in (1, 7, 32, 256):
            assert p.local_batch(gb, n) == r.local_batch(gb, n)
    if mp == 4:
        assert p.shape_for(8) == (2, 4) and p.shape_for(6) == (3, 2)
        assert p.shape_for(7) == (7, 1) and p.local_batch(256, 16) == 64


def test_elastic_mesh_make_feeds_from_mesh():
    """`make(devices=[cpu] * 4)` at model parallelism 2: a (2, 2) grid
    named ("data", "model"), which `from_mesh(axis="data")` shards two
    ways."""
    em = ElasticMesh(model_parallel=2)
    mesh = em.make(devices=[torch.device("cpu")] * 4)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == mesh.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    cache = ShardedSegmentCache.from_mesh(mesh, 1 << 20, axis="data")
    assert cache.n_shards == 2
    one = ElasticMesh().make(devices=["cpu"])
    assert one.devices.shape == (1, 1)
    four = ElasticMesh().make(devices=[torch.device("cpu")] * 4)
    assert four.shape == (4, 1)
    assert ShardedSegmentCache.from_mesh(four, 1 << 20,
                                         axis="data").n_shards == 4


def test_engine_cache_on_elastic_mesh():
    """The engine's `mesh=` with `cache_shard_axis="data"` shards its cache
    over the grid's data axis, as chip_smoke.py's continuous phase builds
    it on one card."""
    from repro_torch.runtime import EngineConfig, ServingEngine
    mesh = ElasticMesh().make(devices=[torch.device("cpu")] * 2)
    eng = ServingEngine(EngineConfig(device_budget_bytes=1 << 20,
                                     cache_shard_axis="data", device="cpu"),
                        mesh=mesh)
    assert isinstance(eng.cache, ShardedSegmentCache)
    assert eng.cache.n_shards == 2


def test_elastic_mesh_make_without_cuda_raises(monkeypatch):
    """No card and no `devices`: it raises instead of building a CPU
    grid."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticMesh().make()


# ---- the seekable token pipeline ------------------------------------------

def test_token_batches_match_reference():
    for step in (0, 1, 41, 1000):
        pt, pl = TokenPipeline(1000, 16, 8, seed=3).batch_at(step)
        rt, rl = RPipeline(1000, 16, 8, seed=3).batch_at(step)
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_array_equal(pl, rl)
        assert pt.dtype == rt.dtype == np.int32
    shards = [TokenPipeline(1000, 16, 8, seed=3, shard_index=i,
                            shard_count=4) for i in range(4)]
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(
            s.batch_at(7)[0], RPipeline(1000, 16, 8, seed=3, shard_index=i,
                                        shard_count=4).batch_at(7)[0])
        assert s.batch_at(7)[0].shape == (2, 16)
    for (pt, pl), (rt, rl) in zip(synthetic_token_batches(50, 5, 3, 4, 9),
                                  r_batches(50, 5, 3, 4, 9)):
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_array_equal(pl, rl)
    it = iter(TokenPipeline(50, 5, 3, seed=9))
    for step in range(3):
        np.testing.assert_array_equal(next(it)[0],
                                      RPipeline(50, 5, 3, 9).batch_at(step)[0])


def test_token_pipeline_rejects_uneven_shards():
    with pytest.raises(ValueError, match="does not split"):
        _ = TokenPipeline(100, 4, 6, shard_count=4).local_batch


def test_restart_replays_the_same_batches():
    """A run that fails at step 5 and restores from a checkpoint at step
    3 sees, from the restart on, the reference pipeline's batches for the
    same steps and seed."""
    pipe = TokenPipeline(500, 12, 4, seed=2)
    seen, ckpt = [], {"step": 0}

    def body(start):
        for step in range(start, 10):
            if step == 5 and not seen.count("failed"):
                seen.append("failed")
                raise RuntimeError("simulated node failure")
            seen.append((step, pipe.batch_at(step)))
            if step % 3 == 0:
                ckpt["step"] = step
        return 10

    state = Supervisor(SupervisorConfig(backoff_s=0.0)).run(
        body, restore=lambda: ckpt["step"])
    assert state.restarts == 1 and state.step == 10
    after = seen[seen.index("failed") + 1:]
    assert [s for s, _ in after] == list(range(3, 10))
    ref = RPipeline(500, 12, 4, seed=2)
    for step, (tokens, labels) in after:
        rt, rl = ref.batch_at(step)
        np.testing.assert_array_equal(tokens, rt)
        np.testing.assert_array_equal(labels, rl)
