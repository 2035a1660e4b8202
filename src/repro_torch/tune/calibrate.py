"""Anchor the simulator's cost model to measured step-time traces.

Port of ``repro/tune/calibrate.py`` (numpy).

The sim prices a step as ``t_compute + rounds * alpha + bytes * beta``
(paper Eq. 1 on the replayed schedules). ``fit`` recovers
``(t_compute, alpha, beta)`` from measured per-step records by linear
least squares on the design matrix ``[1, rounds, bytes]`` — so simulated
predictions (and therefore the tuner's rankings) are anchored to the
hardware the trace came from.

Trace JSON schema (``repro.tune/trace@1``, documented in DESIGN.md §8):

    {"schema": "repro.tune/trace@1",
     "model":   {... provenance: p, d, compressor, buckets, ...},
     "records": [{"step": 0, "t_step": 0.141,          # seconds, wall
                  "rounds": 12, "bytes": 1.3e6,        # CommStats per step
                  "t_compute": 0.1}, ...]}             # optional split

Both launchers emit it: ``repro_torch.launch.train --json PATH`` (records with
t_step/rounds/bytes measured on a REAL run — the zero-extra-tooling
capture path; the document is ``repro.tune/trace@2``, a strict
superset whose records additionally carry ``warmup`` tags and quality
metrics — consumed here unchanged, and the tags replace the positional
``drop_first`` heuristic) and ``repro.launch.simulate --json PATH`` (the
``curves_json`` shape, accepted here as-is for sim-to-sim calibration
checks). ``alpha`` and ``beta`` are only identifiable when the trace
varies rounds/bytes — capture runs at two or three bucket counts (or
methods); ``fit`` raises with that instruction when the design matrix is
rank-deficient rather than returning garbage.

Identifiability note: bucketizing gs-SGD deliberately preserves the
aggregate sketch payload (``_scale_bucket``), so sweeping ONLY the bucket
count varies rounds but not bytes — with an unknown compute term that
leaves beta collinear with the intercept. A proper capture varies both
axes: e.g. two bucket counts x two sketch widths (4 short runs).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.tune.space import Env

TRACE_SCHEMA = "repro.tune/trace@1"


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted Eq. 1 + compute parameters and the fit's quality."""

    alpha: float                # per-round startup (s)
    beta: float                 # per-byte wire time (s/B)
    t_compute: float            # mean fwd+bwd seconds per step
    jitter: float               # cv of the compute residual
    residual: float             # rms step-time fit residual (s)
    n_records: int

    def apply(self, env: Env) -> Env:
        """Env with the calibrated link + compute model substituted in."""
        return dataclasses.replace(env, link_alpha=self.alpha,
                                   link_beta=self.beta,
                                   t_compute=self.t_compute)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _normalize(doc: dict) -> list[dict]:
    """Accept trace@1 ``records`` or ``simulate --json`` ``curves`` rows."""
    if "records" in doc:
        return list(doc["records"])
    if "curves" in doc:  # launch/simulate.curves_json shape
        return [{"step": r.get("step"), "t_step": r["time_sim"],
                 "rounds": r["rounds"], "bytes": r["bytes"],
                 "t_compute": r.get("compute")} for r in doc["curves"]]
    raise ValueError("unrecognized trace document: expected 'records' "
                     "(repro.tune/trace@1) or 'curves' (simulate --json)")


def load_trace(path: str) -> list[dict]:
    if path.endswith(".jsonl"):        # trace@2 streaming layout
        from repro_torch.obs.metrics import load_jsonl
        return _normalize(load_jsonl(path))
    with open(path) as f:
        return _normalize(json.load(f))


def _drop_warmup(records: list[dict], drop_first: int) -> list[dict]:
    """Warmup policy for one trace: trace@2 records carry authoritative
    ``warmup`` tags (train tags the jit-compiling step(s)); when present
    they REPLACE the positional drop_first heuristic. Untagged (trace@1)
    records keep the old behavior: drop the first ``drop_first`` rows."""
    if any("warmup" in r for r in records):
        return [r for r in records if not r.get("warmup")]
    return list(records)[drop_first:]


def _windowed(records: list[dict], window: int | None) -> list[dict]:
    if window is None:
        return records
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return records[-window:]


def fit(traces, *, drop_first: int = 1,
        window: int | None = None) -> Calibration:
    """Least-squares Eq. 1 fit over one or more record lists.

    traces: a record list, or a list of record lists (merge runs captured
    at different bucket counts to make alpha/beta identifiable).
    drop_first: records dropped from the head of EACH trace (jit warmup
    pollutes the first measured step of a real run); ignored for traces
    whose records carry explicit ``warmup`` tags (trace@2).
    window: keep only the trailing ``window`` records of EACH trace
    (after the warmup drop) — the online-refit path: when the fabric
    drifts mid-run, a trailing window recovers the POST-drift parameters
    instead of averaging both regimes.
    """
    if isinstance(traces, dict):       # a whole trace document
        traces = [_normalize(traces)]
    elif traces and isinstance(traces[0], dict):
        if "records" in traces[0] or "curves" in traces[0]:
            traces = [_normalize(t) for t in traces]   # list of documents
        else:
            traces = [traces]                          # one record list
    recs = [r for t in traces
            for r in _windowed(_drop_warmup(list(t), drop_first), window)]
    if len(recs) < 3:
        raise ValueError(f"need >= 3 records after warmup drop, got "
                         f"{len(recs)}")
    t = np.array([r["t_step"] for r in recs], float)
    rounds = np.array([r["rounds"] for r in recs], float)
    nbytes = np.array([r["bytes"] for r in recs], float)
    have_compute = all(r.get("t_compute") is not None for r in recs)
    if have_compute:
        c = np.array([r["t_compute"] for r in recs], float)
        x = np.stack([rounds, nbytes], axis=1)
        y = t - c
        if np.linalg.matrix_rank(x) < 2:
            raise ValueError(
                "trace has no rounds/bytes variation — alpha and beta are "
                "not separable; capture train --json runs that vary both "
                "(e.g. --buckets 1/8 for rounds, --width for bytes)")
        sol, *_ = np.linalg.lstsq(x, y, rcond=None)
        alpha, beta = (max(0.0, v) for v in sol)
        t_compute = float(np.mean(c))
        jit = float(np.std(c) / t_compute) if t_compute > 0 else 0.0
        pred = c + x @ np.array([alpha, beta])
    else:
        x = np.stack([np.ones_like(t), rounds, nbytes], axis=1)
        if np.linalg.matrix_rank(x) < 3:
            raise ValueError(
                "compute, alpha and beta are not jointly identifiable — "
                "the trace must vary BOTH rounds and bytes (e.g. train "
                "--json at --buckets 1/8 x --width 4096/16384), or record "
                "per-step t_compute")
        sol, *_ = np.linalg.lstsq(x, t, rcond=None)
        t_compute, alpha, beta = (max(0.0, v) for v in sol)
        pred = x @ np.array([t_compute, alpha, beta])
        resid_c = t - rounds * alpha - nbytes * beta
        jit = (float(np.std(resid_c) / np.mean(resid_c))
               if np.mean(resid_c) > 0 else 0.0)
    # rms of the CLAMPED parameters — the fit quality of what apply() uses
    rms = float(np.sqrt(np.mean((t - pred) ** 2)))
    return Calibration(alpha=float(alpha), beta=float(beta),
                       t_compute=float(t_compute),
                       jitter=jit, residual=rms, n_records=len(recs))


def fit_profile(records, predicted: dict, *, window: int | None = None,
                clamp: tuple = (0.05, 100.0)):
    """Fit a ``tune.cost.CalibrationProfile`` from measured step records
    against a model prediction — the watchdog's refit step.

    records: per-step dicts (trace@2 row shape); rows tagged ``warmup``
    are dropped, then only the trailing ``window`` rows are used (the
    post-onset regime). predicted: a ``predict_step``-shaped dict for the
    CURRENT spec (keys ``compute``/``encode``/``comm``/``recover``/
    ``step_time``) priced with the identity profile.

    Each phase factor is mean(measured phase)/predicted phase, clamped.
    Records without per-phase splits (train measures only ``t_step``)
    fall back to attributing the entire step-time shift to comm — the
    dominant drift mode (congestion/stragglers) and the conservative
    choice: it makes the tuner prefer comm-lean candidates.
    """
    from repro_torch.tune.cost import CalibrationProfile
    recs = _windowed(_drop_warmup(list(records), 0), window)
    if not recs:
        raise ValueError("no records to fit a profile from")
    factors: dict[str, float] = {}
    for phase in ("compute", "encode", "comm", "recover"):
        pred = predicted.get(phase)
        vals = [r[phase] for r in recs if r.get(phase) is not None]
        if pred is not None and pred > 1e-12 and len(vals) == len(recs):
            factors[phase] = _clamp(float(np.mean(vals)) / pred, clamp)
    if not factors:
        p_comm = predicted.get("comm") or 0.0
        p_step = predicted.get("step_time") or 0.0
        if p_comm > 1e-12:
            shift = float(np.mean([r["t_step"] for r in recs])) - p_step
            factors["comm"] = _clamp(1.0 + shift / p_comm, clamp)
    return CalibrationProfile(**factors)


def _clamp(v: float, clamp: tuple) -> float:
    return min(clamp[1], max(clamp[0], v))


def synthetic_trace(*, alpha: float, beta: float, t_compute: float,
                    cells, steps: int = 4, jitter: float = 0.0,
                    seed: int = 0, model: dict | None = None) -> dict:
    """Planted-parameter trace@1 document (tests + example fixture).

    cells: [(rounds, bytes)] — one per captured configuration; each gets
    ``steps`` records. jitter: multiplicative lognormal-ish noise (cv) on
    the compute term, seeded.
    """
    rng = np.random.default_rng(seed)
    records = []
    step = 0
    for rounds, nbytes in cells:
        for _ in range(steps):
            c = t_compute * (1.0 + jitter * rng.standard_normal()) \
                if jitter > 0 else t_compute
            records.append({"step": step,
                            "t_step": c + rounds * alpha + nbytes * beta,
                            "rounds": int(rounds), "bytes": float(nbytes)})
            step += 1
    return {"schema": TRACE_SCHEMA,
            "model": dict(model or {},
                          planted={"alpha": alpha, "beta": beta,
                                   "t_compute": t_compute,
                                   "jitter": jitter, "seed": seed}),
            "records": records}
