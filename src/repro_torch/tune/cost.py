"""Candidate pricing: real-sim replay time + count-sketch recovery fidelity.

Port of ``repro/tune/cost.py``.

``CostModel.evaluate`` prices one ``Candidate`` in one ``Env`` with two
independent measurements:

* **time** — ``sim.replay.predict_step``: the candidate's real compressor
  geometry (``compression.bucketize`` scaling included) replayed over the
  real collective schedules on the env's network model, with the bucket
  pipeline / backward-interleave priced by the shared
  ``compression.overlap_schedule_time`` / ``interleaved_schedule_time``
  recurrences. This is byte-for-byte what ``sim/cluster.simulate`` charges
  a jitter-free step, so tuner rankings transfer to full event-loop runs.

* **fidelity** — an *error proxy* measured by running the port's encode
  and HEAVYMIX recovery (``kernels.ops.encode`` +
  ``kernels.ops.heavymix_recover``, on the model's ``device``: on the card
  they launch the hand-written kernels) on a seeded heavy-tailed probe
  gradient scaled into the candidate's per-bucket geometry: the
  proxy is ``1 - (l2 mass captured by the recovered top-k)``, i.e. the
  residual the error-feedback accumulator would carry. Sparsification
  baselines (topk/gtopk) are probed with their exact top-k selection;
  dense is 0 by definition. The probe dimension is small (default 2^14)
  and geometry-cached, so sweeping hundreds of candidates stays cheap;
  it ranks candidates, it does not predict end-to-end convergence.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core import count_sketch as cs
from repro_torch.kernels import ops as kops
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.sim.replay import ExchangeReplay, predict_step
from repro_torch.tune.space import Candidate, Env, validate

_ZIPF_EXP = 1.1  # heavy-tail exponent of the probe gradient (paper premise)


def _clamped(v: float, clamp: tuple) -> float:
    return min(clamp[1], max(clamp[0], v))


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Per-phase multiplicative correction of the model's times to
    measured reality — the feedback half of the truth loop.

    ``predict_step(profile=...)`` multiplies compute by ``compute`` and
    the per-bucket StageTimes by ``encode``/``comm``/``recover`` BEFORE
    the overlap/interleave recurrence runs, so a congested link (comm
    factor > 1) stretches the schedule the way the fabric would. The
    identity profile is pinned bit-exact against the unprofiled output:
    ``scale_stages`` returns the input object untouched when every stage
    factor is 1.0 (and x * 1.0 is bit-exact for finite floats anyway).
    """

    compute: float = 1.0
    encode: float = 1.0
    comm: float = 1.0
    recover: float = 1.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not (v > 0 and math.isfinite(v)):
                raise ValueError(
                    f"calibration factor {f.name} must be a positive "
                    f"finite number, got {v}")

    def is_identity(self) -> bool:
        return (self.compute == self.encode == self.comm
                == self.recover == 1.0)

    def scale_stages(self, st):
        """Scaled copy of a ``sim.replay.StageTimes`` (identity: the
        same object, untouched)."""
        if self.encode == self.comm == self.recover == 1.0:
            return st
        return dataclasses.replace(
            st,
            t_enc=tuple(t * self.encode for t in st.t_enc),
            t_comm=tuple(t * self.comm for t in st.t_comm),
            t_rec=tuple(t * self.recover for t in st.t_rec))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "CalibrationProfile":
        return cls(**(d or {}))

    @classmethod
    def from_audit(cls, audit: dict,
                   clamp: tuple = (0.05, 100.0)) -> "CalibrationProfile":
        """Fit from an overlap-audit report (the reference's
        ``benchmarks/overlap_audit.py`` writes them): each phase
        factor is measured/predicted from the audit's ``phase_deltas``
        (compute from the forward+backward block), clamped to ``clamp``;
        a phase the audit did not resolve (predicted ~0) stays 1.0."""
        deltas = audit.get("phase_deltas") or {}
        factors = {}
        for phase in ("encode", "comm", "recover"):
            row = deltas.get(phase) or {}
            pred, meas = row.get("predicted"), row.get("measured")
            if pred and meas is not None and pred > 1e-12:
                factors[phase] = _clamped(meas / pred, clamp)
        mp = (audit.get("measured") or {}).get("phases") or {}
        pp = audit.get("predicted") or {}
        m_comp = (mp.get("forward") or 0.0) + (mp.get("backward") or 0.0)
        p_comp = (pp.get("forward") or 0.0) + (pp.get("backward") or 0.0)
        if p_comp > 1e-12 and m_comp > 0:
            factors["compute"] = _clamped(m_comp / p_comp, clamp)
        return cls(**factors)


@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """One candidate's predicted step economics (all seconds/bytes/step)."""

    step_time: float        # compute + exposed exchange
    exposed_comm: float     # encode + comm overhang past the backward
    encode: float
    comm: float
    recover: float
    comm_serial: float      # un-overlapped comm (the saving's baseline)
    bytes_critical: float   # per-worker Eq. 1 payload term
    bytes_wire: float
    rounds: int
    error_proxy: float      # 1 - captured l2 mass (0 = exact)
    compression: float      # dense critical bytes / candidate critical bytes

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def probe_gradient(d: int, seed: int = 0) -> np.ndarray:
    """Seeded heavy-tailed (Zipf-magnitude) gradient: the distribution
    regime in which sketch recovery is meaningful at all."""
    rng = np.random.default_rng(seed)
    mags = np.arange(1, d + 1, dtype=np.float64) ** -_ZIPF_EXP
    signs = rng.choice(np.array([-1.0, 1.0]), size=d)
    return (mags[rng.permutation(d)] * signs).astype(np.float32)


def _pow2_floor(x: float, lo: int) -> int:
    return max(lo, 1 << int(math.floor(math.log2(max(x, lo)))))


def recovery_error(u: np.ndarray, cfg: cs.SketchConfig, k: int,
                   device) -> tuple[float, float]:
    """(missed, total) l2 mass of ``u`` after one Count-Sketch encode and
    HEAVYMIX recovery of ``k`` coordinates on ``device`` (the kernels on
    the card, their plain versions on the CPU)."""
    g = torch.from_numpy(u).to(device)
    idx = kops.heavymix_recover(cfg, kops.encode(cfg, g), k, u.size)[0]
    sel = idx.cpu().numpy()
    total = float(np.sum(u.astype(np.float64) ** 2))
    captured = float(np.sum(u[sel].astype(np.float64) ** 2))
    return max(0.0, total - captured), total


class CostModel:
    """Prices candidates for one env; caches the network, the dense
    baseline bytes, and per-geometry error probes across evaluations.
    ``device``: where the error probe encodes and recovers (None = the
    card, raising without one; only read when a probe runs)."""

    def __init__(self, env: Env, *, error_probe: bool = True,
                 probe_d: int = 1 << 14, probe_seed: int = 0,
                 profile: "CalibrationProfile | None" = None,
                 device=None):
        self.env = env
        self.device = device
        self.net = env.network()
        self.error_probe = error_probe
        self.profile = profile
        self.probe_d = int(probe_d)
        self.probe_seed = int(probe_seed)
        self._probe_cache: dict[tuple, float] = {}
        self._dense_bytes = comp.static_comm_stats(
            None, env.d, env.p).bytes_out

    # -- time ---------------------------------------------------------------

    def evaluate(self, cand: Candidate,
                 rep: ExchangeReplay | None = None) -> CandidateCost:
        rep = rep if rep is not None else validate(cand, self.env)
        pred = predict_step(
            cand.method, self.env.d, self.env.p, bwd_chunks=cand.bwd_chunks,
            group_size=self.env.group_size, t_compute=self.env.t_compute,
            bwd_frac=self.env.bwd_frac, fuse_encode=self.env.fuse_encode,
            participation=self.env.participation,
            net=self.net, replay=rep, profile=self.profile)
        err = self.error_proxy(cand, rep) if self.error_probe else 0.0
        bc = pred["bytes_critical"]
        return CandidateCost(
            step_time=pred["step_time"], exposed_comm=pred["exposed_comm"],
            encode=pred["encode"], comm=pred["comm"],
            recover=pred["recover"], comm_serial=pred["comm_serial"],
            bytes_critical=bc, bytes_wire=pred["bytes_wire"],
            rounds=pred["rounds"], error_proxy=err,
            compression=(self._dense_bytes / bc if bc > 0 else float("inf")))

    # -- fidelity -----------------------------------------------------------

    def error_proxy(self, cand: Candidate, rep: ExchangeReplay) -> float:
        """Residual l2 mass after recovery on the scaled probe (see module
        docstring). Deterministic in (probe_seed, geometry)."""
        if cand.method == "dense":
            return 0.0
        scale = min(1.0, self.probe_d / max(1, self.env.d))
        missed = total = 0.0
        for i, (c, d_b) in enumerate(zip(rep.bc.parts, rep.bc.spec.sizes)):
            m, t = self._bucket_probe(cand.method, c, d_b, scale, i)
            missed += m
            total += t
        return missed / total if total > 0 else 0.0

    def _bucket_probe(self, method: str, c, d_b: int, scale: float,
                      i: int) -> tuple[float, float]:
        d_p = max(64, int(round(d_b * scale)))
        k_p = max(1, min(d_p, int(round(c.k * scale)))) if hasattr(c, "k") \
            else d_p
        if method in ("gs-sgd", "sketched-sgd"):
            w_p = min(c.sketch.width,
                      _pow2_floor(c.sketch.width * scale, 64))
            key = (method, d_p, k_p, c.sketch.rows, w_p,
                   c.sketch.seed, self.probe_seed + i)
        else:
            key = (method, d_p, k_p, self.probe_seed + i)
        hit = self._probe_cache.get(key)
        if hit is not None:
            return hit
        u = probe_gradient(d_p, seed=self.probe_seed + i)
        if method in ("gs-sgd", "sketched-sgd"):
            cfg = cs.SketchConfig(rows=c.sketch.rows, width=w_p,
                                  seed=c.sketch.seed)
            out = recovery_error(u, cfg, k_p, resolve_device(self.device))
        else:  # topk / gtopk: exact local top-k selection
            total = float(np.sum(u.astype(np.float64) ** 2))
            sel = np.argpartition(np.abs(u), d_p - k_p)[d_p - k_p:]
            captured = float(np.sum(u[sel].astype(np.float64) ** 2))
            out = (max(0.0, total - captured), total)
        self._probe_cache[key] = out
        return out
