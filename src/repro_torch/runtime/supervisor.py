"""Fault-tolerant run supervisor: restart, straggler policy, elastic mesh.

What a long-running deployment needs from its controlling process:
  * crash recovery — `run()` wraps the step loop; on a recoverable failure
    it restores the newest checkpoint and resumes (bounded retries with
    exponential backoff). The seekable data pipeline guarantees batch k is
    identical after restart.
  * straggler mitigation — the streaming layers (io.DoubleBufferedStreamer)
    re-issue transfers past a deadline; at the step level, the supervisor
    tracks a rolling step-time EWMA and flags steps > `straggler_factor`×
    EWMA, feeding the deadline back to the streamer.
  * elastic scaling — `ElasticMesh.shape_for(n_devices)` recomputes the
    mesh shape from the available device count; batch ramping keeps the
    global batch divisible by the new data-parallel degree.

A copy of `repro.runtime.supervisor`. `Supervisor`, `SupervisorConfig` and
`RunState` are plain Python; `ElasticMesh.make` returns a `DeviceGrid` (axis
names and a NumPy grid of `torch.device`s, what
`ShardedSegmentCache.from_mesh` reads) where the reference builds a JAX
mesh. One card needs no process group.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 3
    backoff_s: float = 0.1
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class RunState:
    step: int = 0
    restarts: int = 0
    straggler_events: int = 0
    step_time_ewma: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGrid:
    """A named grid of devices: `devices[i, j]` is the device at index i of
    `axis_names[0]` and j of `axis_names[1]`."""

    devices: np.ndarray          # object array of torch.device
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)


class ElasticMesh:
    """Mesh factory that adapts to the live device count."""

    def __init__(self, model_parallel: int = 1, axis_names=("data", "model")):
        self.model_parallel = model_parallel
        self.axis_names = axis_names

    def shape_for(self, n_devices: int) -> Tuple[int, int]:
        mp = math.gcd(self.model_parallel, n_devices)
        return (n_devices // mp, mp)

    def make(self, devices: Optional[List[torch.device]] = None
             ) -> DeviceGrid:
        """The grid over `devices`, by default every visible CUDA card.
        Without a card and without `devices` it raises: it never builds a
        CPU grid unasked."""
        if devices is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "ElasticMesh.make: no CUDA device is visible; pass "
                    "devices=[torch.device('cpu')] * n for a CPU grid")
            devices = [torch.device("cuda", i) for i in range(n)]
        devices = [torch.device(d) for d in devices]
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        return DeviceGrid(grid.reshape(self.shape_for(len(devices))),
                          tuple(self.axis_names))

    def local_batch(self, global_batch: int, n_devices: int) -> int:
        dp = self.shape_for(n_devices)[0]
        # Ramp global batch down to the nearest multiple if a node was lost.
        return max(1, global_batch // dp)


class Supervisor:
    def __init__(self, config: SupervisorConfig,
                 checkpointer=None,
                 recoverable: Tuple[type, ...] = (RuntimeError,)):
        self.config = config
        self.checkpointer = checkpointer
        self.recoverable = recoverable
        self.state = RunState()

    def observe_step(self, seconds: float) -> bool:
        """Track step time; returns True if this step was a straggler."""
        st = self.state
        if st.step_time_ewma == 0.0:
            st.step_time_ewma = seconds
            return False
        is_straggler = seconds > self.config.straggler_factor * st.step_time_ewma
        if is_straggler:
            st.straggler_events += 1
        # Clamp stragglers out of the EWMA so one hiccup doesn't raise the bar.
        st.step_time_ewma = (
            (1 - self.config.ewma_alpha) * st.step_time_ewma
            + self.config.ewma_alpha * min(
                seconds, self.config.straggler_factor * st.step_time_ewma))
        return is_straggler

    def stream_deadline(self) -> Optional[float]:
        """Deadline handed to DoubleBufferedStreamer for re-issue."""
        if self.state.step_time_ewma == 0.0:
            return None
        return self.config.straggler_factor * self.state.step_time_ewma

    def run(self, body: Callable[[int], int],
            restore: Optional[Callable[[], int]] = None) -> RunState:
        """body(start_step) -> last_step; restore() -> start_step.

        Restarts `body` on recoverable failures, restoring from the newest
        checkpoint each time.
        """
        start = self.state.step
        while True:
            try:
                self.state.step = body(start)
                return self.state
            except self.recoverable as err:  # noqa: PERF203
                self.state.restarts += 1
                if self.state.restarts > self.config.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.config.max_restarts}"
                    ) from err
                time.sleep(self.config.backoff_s * 2 ** (self.state.restarts - 1))
                start = restore() if restore is not None else start
