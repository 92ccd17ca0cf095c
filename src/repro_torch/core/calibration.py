"""Online cost-model calibration: fit `TierSpec` coefficients from traffic.

Admission control, EDF ordering, backpressure and every pass's cost delta
price plans through `PipelinePlan.estimate()` against a `TierSpec`.
:class:`CostCalibrator` fits that spec to what the card really does:

  * **per-path transfer timings** (`observe_transfer` / `observe_records`
    over `TransferRecord`s, by `Path` and hop count) fit, per path, the
    linear model ``seconds = latency_s·hops + bytes/bw`` by accumulated
    least squares;
  * **request-level prediction error** (`observe_error` / `observe_batch`
    over `RequestLatency`-shaped objects) keeps an EWMA of
    ``processing_s / predicted_s`` — the one online signal a long-lived
    serving engine has — applied as a scale to paths that have no direct
    transfer observations.

`calibrated(base)` is a view: a new `TierSpec` with only `bw` and
`latency_s` rewritten, so it drops in wherever the static spec did. With
zero observations it returns `base` itself, so calibration off stays
bit-exact. Fits are trust-blended: after ``n`` observation rounds a path's
coefficients are ``(1-w)·base + w·fitted`` with ``w = 1-(1-blend)^n``.
`generation` increments on every state change; the serving engine compares
it to drop stale cost memos and reprice its queue.

The arithmetic is `repro.core.calibration`'s, operation for operation,
which the tests hold it to.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.io.tiers import Path, TierSpec, TransferRecord

__all__ = ["CostCalibrator", "PathEstimate"]


@dataclasses.dataclass
class _PathModel:
    """Accumulated least-squares moments for one path's linear model
    ``seconds = θ₀·hops + θ₁·bytes`` (θ₀ = setup latency per link,
    θ₁ = 1/effective bandwidth). Moments, not samples: O(1) state no
    matter how long the engine serves."""

    n_obs: int = 0        # individual transfers folded in
    rounds: int = 0       # observation rounds (trust grows per round)
    s_hh: float = 0.0
    s_hb: float = 0.0
    s_bb: float = 0.0
    s_hs: float = 0.0
    s_bs: float = 0.0

    def observe(self, hops: float, nbytes: float, seconds: float) -> None:
        h, b, s = float(hops), float(nbytes), float(seconds)
        self.n_obs += 1
        self.s_hh += h * h
        self.s_hb += h * b
        self.s_bb += b * b
        self.s_hs += h * s
        self.s_bs += b * s

    def fit(self, base_latency_s: float) -> Optional[Tuple[float, float]]:
        """Solve the 2×2 normal equations; returns ``(latency_s, inv_bw)``
        or None with no observations. Degenerate designs (every sample at
        the same bytes-per-hop ratio cannot separate setup from bandwidth)
        keep the base latency and fit only the bandwidth term — which
        still reproduces the observed seconds at the observed sizes."""
        if self.n_obs == 0:
            return None
        det = self.s_hh * self.s_bb - self.s_hb * self.s_hb
        if det > 1e-9 * max(self.s_hh * self.s_bb, 1e-300):
            lat = (self.s_bb * self.s_hs - self.s_hb * self.s_bs) / det
            inv_bw = (self.s_hh * self.s_bs - self.s_hb * self.s_hs) / det
        else:
            lat = base_latency_s
            inv_bw = ((self.s_bs - lat * self.s_hb) / self.s_bb
                      if self.s_bb > 0.0 else 0.0)
        return max(lat, 0.0), max(inv_bw, 1e-300)


@dataclasses.dataclass(frozen=True)
class PathEstimate:
    """One path's calibration reading: the raw fit and the trust weight
    the calibrated view blends it in with."""

    path: Path
    n_obs: int
    rounds: int
    bw: float           # fitted effective bandwidth, bytes/s
    latency_s: float    # fitted per-link setup latency
    trust: float        # blend weight w = 1-(1-blend)^rounds


class CostCalibrator:
    """Online per-path bandwidth/latency fits + request-error EWMA,
    exposed as a calibrated `TierSpec` view (see module docstring)."""

    def __init__(self, blend: float = 0.5, error_alpha: float = 0.25):
        if not 0.0 < blend <= 1.0:
            raise ValueError(f"blend must be in (0, 1], got {blend}")
        if not 0.0 < error_alpha <= 1.0:
            raise ValueError(
                f"error_alpha must be in (0, 1], got {error_alpha}")
        self.blend = float(blend)
        self.error_alpha = float(error_alpha)
        self._models: Dict[Path, _PathModel] = {}
        # Request-error channel: EWMA of processing_s / predicted_s.
        self._error_ratio = 1.0
        self._error_rounds = 0
        self._error_n = 0
        # Bumped on every state change; the engine invalidates its
        # `_pass_costs` memos (and reprices its queue) when it moves.
        self.generation = 0

    # ---- observation: per-path transfer timings --------------------------

    def observe_transfer(self, path: Path, nbytes: int, seconds: float,
                         hops: int = 1) -> None:
        """Fold one observed transfer into `path`'s fit (one trust round)."""
        if nbytes <= 0 or seconds <= 0.0:
            return
        m = self._models.setdefault(path, _PathModel())
        m.observe(max(int(hops), 1), int(nbytes), float(seconds))
        m.rounds += 1
        self.generation += 1

    def observe_records(self, records: Iterable[TransferRecord]) -> int:
        """Fold a batch of `TransferRecord`s (one trust round per path
        that received any). Records store *wire* bytes (payload × hops);
        the fit is over payload bytes, recovered from the hop count.
        Returns the number of records consumed."""
        touched: Dict[Path, int] = {}
        for rec in records:
            hops = max(int(getattr(rec, "hops", 1)), 1)
            payload = rec.nbytes // hops
            if payload <= 0 or rec.seconds <= 0.0:
                continue
            m = self._models.setdefault(rec.path, _PathModel())
            m.observe(hops, payload, rec.seconds)
            touched[rec.path] = touched.get(rec.path, 0) + 1
        for path in touched:
            self._models[path].rounds += 1
        if touched:
            self.generation += 1
        return sum(touched.values())

    # ---- observation: request-level prediction error ---------------------

    def observe_error(self, latency: Any) -> bool:
        """Fold one `RequestLatency`-shaped sample (``predicted_s`` +
        ``processing_s`` attributes) into the error-ratio EWMA. Samples
        with a non-positive prediction carry no ratio and are skipped."""
        predicted = float(getattr(latency, "predicted_s", 0.0))
        processing = float(getattr(latency, "processing_s", 0.0))
        if predicted <= 0.0 or processing <= 0.0:
            return False
        a = self.error_alpha
        self._error_ratio = ((1.0 - a) * self._error_ratio
                             + a * (processing / predicted))
        self._error_n += 1
        self.generation += 1
        return True

    def observe_batch(self, latencies: Iterable[Any]) -> int:
        """Fold a batch of request latencies (one error trust round)."""
        n = sum(1 for lat in latencies if self.observe_error(lat))
        if n:
            self._error_rounds += 1
        return n

    # ---- readings --------------------------------------------------------

    def _trust(self, rounds: int) -> float:
        return 1.0 - (1.0 - self.blend) ** rounds

    def fitted(self, path: Path,
               base: Optional[TierSpec] = None) -> Optional[Tuple[float, float]]:
        """Raw (unblended) fit for `path`: ``(bw, latency_s)`` or None."""
        m = self._models.get(path)
        if m is None:
            return None
        base_lat = base.latency_s.get(path, 0.0) if base is not None else 0.0
        fit = m.fit(base_lat)
        if fit is None:
            return None
        lat, inv_bw = fit
        return 1.0 / inv_bw, lat

    def estimates(self, base: TierSpec) -> List[PathEstimate]:
        out = []
        for path, m in sorted(self._models.items(), key=lambda kv: kv[0].value):
            fit = self.fitted(path, base)
            if fit is None:
                continue
            bw, lat = fit
            out.append(PathEstimate(path, m.n_obs, m.rounds, bw, lat,
                                    self._trust(m.rounds)))
        return out

    @property
    def error_scale(self) -> float:
        """Trust-weighted processing/predicted ratio — the scale applied
        to paths without direct transfer observations."""
        w = self._trust(self._error_rounds)
        return 1.0 + w * (self._error_ratio - 1.0)

    def calibrated(self, base: TierSpec) -> TierSpec:
        """Calibrated view of `base`: per-path `bw`/`latency_s` replaced
        by trust-blended fits (blending in inverse-bandwidth space, so
        modeled seconds interpolate linearly); paths with no direct
        observations scaled by the request-error channel. Capacities,
        `hbm_bw` and every byte-accounting field pass through untouched.
        With zero observations this returns `base` itself — the
        calibration-off identity the golden tests pin."""
        if self.generation == 0:
            return base
        scale = self.error_scale
        bw = dict(base.bw)
        lat = dict(base.latency_s)
        for path in bw:
            m = self._models.get(path)
            fit = m.fit(base.latency_s.get(path, 0.0)) if m is not None \
                else None
            if fit is not None:
                fit_lat, fit_inv = fit
                w = self._trust(m.rounds)
                inv = (1.0 - w) / bw[path] + w * fit_inv
                bw[path] = 1.0 / inv
                lat[path] = (1.0 - w) * lat[path] + w * fit_lat
            elif scale != 1.0:
                bw[path] = bw[path] / scale
                lat[path] = lat[path] * scale
        return dataclasses.replace(base, bw=bw, latency_s=lat)
