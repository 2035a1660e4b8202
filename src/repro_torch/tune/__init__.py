"""repro_torch.tune — sim-driven auto-tuner for the gs-SGD exchange pipeline.

Port of ``repro/tune``: search the joint (buckets, bwd_chunks, rows,
width, top-k fraction, collective) space by replaying candidates through
the simulator's pricing (``sim/replay.py``), anchor the cost model to
hardware with trace calibration, and emit a serializable ``TunePlan`` the
train driver applies through its own flag path.

    space.py      — Env / Candidate / SearchSpace + runtime-reused validation
    cost.py       — CostModel: replay step time + HEAVYMIX error probe
    search.py     — deterministic grid/budgeted search -> TunePlan
    calibrate.py  — fit Eq. 1 alpha/beta + compute from measured traces
    plan.py       — TunePlan (JSON): save/load + train application
    watch.py      — the drift watchdog (detect -> refit -> re-plan)

CLI: ``python -m repro_torch.launch.tune``.
"""

from repro_torch.tune.calibrate import (TRACE_SCHEMA, Calibration, fit,
                                        fit_profile, load_trace,
                                        synthetic_trace)
from repro_torch.tune.cost import (CalibrationProfile, CandidateCost,
                                   CostModel, probe_gradient)
from repro_torch.tune.plan import TunePlan
from repro_torch.tune.search import search
from repro_torch.tune.space import (Candidate, Env, SearchSpace,
                                    enumerate_valid, validate)
from repro_torch.tune.watch import Watchdog, predict_phases

__all__ = [
    "Calibration", "CalibrationProfile", "Candidate", "CandidateCost",
    "CostModel", "Env", "SearchSpace", "TRACE_SCHEMA", "TunePlan",
    "Watchdog", "enumerate_valid", "fit", "fit_profile", "load_trace",
    "predict_phases", "probe_gradient", "search", "synthetic_trace",
    "validate",
]
