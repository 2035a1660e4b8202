"""repro_torch.sim — deterministic discrete-event simulator of a gs-SGD
cluster (port of ``repro/sim``; NumPy, no torch, nothing on a device).

    engine.py   — seeded, insertion-ordered event loop
    network.py  — alpha-beta link models, topologies, collective replay on
                  the port's ``allreduce.reduce_schedule``
    workers.py  — per-worker compute-time distributions
    traces.py   — scripted fail / join / straggle / congest scenarios (JSON)
    replay.py   — exchange pricing from the port's compressors + the
                  ``overlap_schedule_time`` bucket-pipeline recurrence
    cluster.py  — the timeline: the port's HeartbeatMonitor / ElasticPlan /
                  DeadlinePolicy driven by simulated time; two identical
                  engines ('batched' vectorized / 'loop' compat)

Every time it reports is the model's simulated clock, never a device
metric. CLI: ``python -m repro_torch.launch.simulate``.
"""

from repro_torch.sim.cluster import (SimConfig, SimResult, StepRecord,
                                     sample_cohort, simulate)
from repro_torch.sim.engine import BatchedEventLoop, EventLoop
from repro_torch.sim.network import (LINK_1GBE, LINK_10GBE, LINK_ICI,
                                     Heterogeneous, Hierarchical, Homogeneous,
                                     LinkSpec, NetworkModel, RoundCost,
                                     allreduce_cost,
                                     hierarchical_allreduce_cost,
                                     make_network, pairwise_rounds,
                                     ps_gather_cost, ring_allreduce_cost,
                                     tree_allreduce_cost)
from repro_torch.sim.replay import (ExchangeReplay, PhaseCost, StageTimes,
                                    default_geometry, predict_step)
from repro_torch.sim.traces import FaultTrace, TraceEvent, synthetic
from repro_torch.sim.workers import ComputeModel

__all__ = [
    "SimConfig", "SimResult", "StepRecord", "simulate", "sample_cohort",
    "EventLoop", "BatchedEventLoop",
    "LinkSpec", "NetworkModel", "Homogeneous", "Hierarchical",
    "Heterogeneous", "RoundCost", "LINK_1GBE", "LINK_10GBE", "LINK_ICI",
    "make_network", "pairwise_rounds", "tree_allreduce_cost",
    "ring_allreduce_cost", "ps_gather_cost", "hierarchical_allreduce_cost",
    "allreduce_cost", "ExchangeReplay", "PhaseCost", "StageTimes",
    "default_geometry", "predict_step", "FaultTrace", "TraceEvent",
    "synthetic", "ComputeModel",
]
