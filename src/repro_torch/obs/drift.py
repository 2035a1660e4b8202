"""Streaming drift detection over trace@2 step records (DESIGN.md §12).

Port of ``repro/obs/drift.py`` (pure Python; the same detector, events
and detection bound).

The watchdog's front end: a deterministic per-phase change test that
turns the post-hoc overlap audit into an online signal. Each monitored
phase stream (compute / encode / comm / recover / t_step) learns a
FROZEN baseline from its first ``warmup`` untagged records, then runs a
two-sided Page-Hinkley test on the *relative* residual

    r_t = (x_t - mu) / max(|mu|, tiny)

so thresholds are scale-free: a sustained relative shift ``rho`` alarms
after at most ``ceil(threshold / (min(|rho|, clip) - delta))`` drifted
records (``detection_bound``), and a jitter-free stream (r_t == 0
exactly) can never alarm — the zero-false-positive guarantee
``benchmarks/drift_audit.py`` asserts.

Residuals are winsorized at ``clip`` before accumulating, so a single
transient spike (a replan stall, one straggler barrier) contributes at
most ``clip - delta`` and cannot alarm on its own; only sustained drift
crosses ``threshold``. The baseline is frozen — not EWMA-tracked —
after warmup, which is what makes the latency bound exact and keeps the
detector deterministic for a given record stream.

Alarms are attributed to the phase whose test fired, emitted as
structured ``drift.detected`` instants through the ambient
``trace.current()`` tracer, and returned as ``DriftEvent`` rows with the
estimated onset (the step of the last Page-Hinkley minimum = the last
step that still looked clean; drifted records are ``step > onset``) so
a calibration refit can window from there.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.obs import trace

#: Streams monitored by default. "stall" is deliberately excluded: its
#: clean baseline is ~0, so any transient (elastic replan, one-off
#: straggler) would explode the relative residual.
DEFAULT_PHASES = ("compute", "encode", "comm", "recover", "t_step")

_TINY = 1e-12


def detection_bound(rel: float, *, delta: float, threshold: float,
                    clip: float = 1.0) -> int:
    """Worst-case drifted records before a sustained relative shift of
    ``rel`` alarms. Infinite (returned as a large int) if the shift is
    inside the ``delta`` slack."""
    eff = min(abs(rel), clip) - delta
    if eff <= 0:
        return 1 << 30
    return int(math.ceil(threshold / eff))


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One alarm: which phase drifted, which way, and since when."""

    step: int           # step whose record fired the alarm
    phase: str          # compute | encode | comm | recover | t_step
    direction: str      # "up" (slower) | "down" (faster)
    value: float        # the firing record's phase time
    baseline: float     # frozen post-warmup mean
    rel: float          # (value - baseline) / baseline
    stat: float         # Page-Hinkley statistic at the alarm
    onset: int          # estimated LAST CLEAN step (the PH minimum);
                        # drifted records are those with step > onset

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _PhaseStream:
    """Frozen-mean baseline + two-sided Page-Hinkley for one phase."""

    __slots__ = ("name", "delta", "threshold", "warmup", "clip",
                 "_n", "_sum", "mean", "_m_up", "_min_up", "_m_dn",
                 "_min_dn", "_min_step_up", "_min_step_dn")

    def __init__(self, name: str, *, delta: float, threshold: float,
                 warmup: int, clip: float):
        self.name = name
        self.delta = delta
        self.threshold = threshold
        self.warmup = warmup
        self.clip = clip
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._sum = 0.0
        self.mean = 0.0
        self._m_up = self._min_up = 0.0
        self._m_dn = self._min_dn = 0.0
        self._min_step_up = self._min_step_dn = -1

    def observe(self, x: float, step: int) -> "DriftEvent | None":
        if self._n < self.warmup:
            self._n += 1
            self._sum += x
            if self._n == self.warmup:
                self.mean = self._sum / self._n
            return None
        r = (x - self.mean) / max(abs(self.mean), _TINY)
        r = max(-self.clip, min(self.clip, r))
        # two one-sided CUSUM/Page-Hinkley accumulators on the clipped
        # relative residual; the running minimum marks the last clean step
        self._m_up += r - self.delta
        if self._m_up < self._min_up:
            self._min_up, self._min_step_up = self._m_up, step
        self._m_dn += -r - self.delta
        if self._m_dn < self._min_dn:
            self._min_dn, self._min_step_dn = self._m_dn, step
        ph_up = self._m_up - self._min_up
        ph_dn = self._m_dn - self._min_dn
        if max(ph_up, ph_dn) <= self.threshold:
            return None
        up = ph_up >= ph_dn
        onset = self._min_step_up if up else self._min_step_dn
        return DriftEvent(
            step=step, phase=self.name, direction="up" if up else "down",
            value=x, baseline=self.mean,
            rel=(x - self.mean) / max(abs(self.mean), _TINY),
            stat=ph_up if up else ph_dn,
            onset=onset if onset >= 0 else step)


class DriftDetector:
    """Deterministic streaming drift detector over trace@2 records.

    Feed ``observe(record)`` one per-step dict (the trace@2 ``records``
    row shape: ``t_step`` plus optional per-phase keys). Records tagged
    ``warmup`` are skipped entirely — they never enter the baseline.
    Returns the list of ``DriftEvent`` alarms this record fired (usually
    empty), each also emitted as a ``drift.detected`` instant through the
    ambient ``trace.current()`` tracer.

    ``reset()`` re-arms every stream (fresh baseline + fresh test) — the
    watchdog calls it after applying a re-plan, so the detector re-learns
    the post-plan regime instead of alarming on the plan change itself.
    """

    def __init__(self, *, delta: float = 0.1, threshold: float = 1.5,
                 warmup: int = 5, clip: float = 1.0,
                 phases: tuple = DEFAULT_PHASES):
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        if not 0 < clip:
            raise ValueError(f"clip must be > 0, got {clip}")
        self.delta = delta
        self.threshold = threshold
        self.warmup = warmup
        self.clip = clip
        self.phases = tuple(phases)
        self.events: list[DriftEvent] = []
        self._streams = {
            ph: _PhaseStream(ph, delta=delta, threshold=threshold,
                             warmup=warmup, clip=clip)
            for ph in self.phases}

    def reset(self) -> None:
        for s in self._streams.values():
            s.reset()

    def baseline(self, phase: str) -> float | None:
        """Frozen baseline mean for ``phase`` (None while warming up)."""
        s = self._streams[phase]
        return s.mean if s._n >= s.warmup else None

    def observe(self, record: dict, *, step: int | None = None,
                ts: float | None = None) -> list[DriftEvent]:
        if record.get("warmup"):
            return []
        at = int(record.get("step", 0) if step is None else step)
        fired: list[DriftEvent] = []
        for ph in self.phases:
            x = record.get(ph)
            if x is None:
                continue
            ev = self._streams[ph].observe(float(x), at)
            if ev is None:
                continue
            fired.append(ev)
            self.events.append(ev)
            tr = trace.current()
            tr.instant(
                "drift.detected", cat="runtime", track="watchdog",
                ts=ts, args=ev.to_json())
            # one alarm consumed the evidence; restart this stream's test
            # (fresh baseline) so it re-learns the new regime
            self._streams[ph].reset()
        return fired
