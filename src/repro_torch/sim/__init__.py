"""repro_torch.sim — the simulator's pricing oracle.

Port of ``repro/sim`` as far as the train driver, the tuner and the
watchdog need it:

    network.py  — alpha-beta link models, topologies, collective replay on
                  the port's ``allreduce.reduce_schedule``
    workers.py  — per-worker compute-time distributions
    replay.py   — exchange pricing from the port's compressors + the
                  ``overlap_schedule_time`` bucket-pipeline recurrence
    cluster.py  — ``SimConfig`` only

The event-loop engines (``cluster.simulate``, ``engine.py``), the fault
traces (``traces.py``) and ``launch/simulate.py`` come in a later slice.
"""

from repro_torch.sim.cluster import SimConfig
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
from repro_torch.sim.workers import ComputeModel

__all__ = [
    "SimConfig", "LinkSpec", "NetworkModel", "Homogeneous", "Hierarchical",
    "Heterogeneous", "RoundCost", "LINK_1GBE", "LINK_10GBE", "LINK_ICI",
    "make_network", "pairwise_rounds", "tree_allreduce_cost",
    "ring_allreduce_cost", "ps_gather_cost", "hierarchical_allreduce_cost",
    "allreduce_cost", "ExchangeReplay", "PhaseCost", "StageTimes",
    "default_geometry", "predict_step", "ComputeModel",
]
