"""repro_torch.runtime — elastic membership, heartbeat failure detection
and the straggler deadline policy (port of ``repro/runtime``)."""

from repro_torch.runtime.elastic import (ElasticPlan, carry_survivors,
                                         initial_plan, replan)
from repro_torch.runtime.heartbeat import HeartbeatMonitor
from repro_torch.runtime.straggler import DeadlinePolicy

__all__ = ["ElasticPlan", "initial_plan", "replan", "carry_survivors",
           "HeartbeatMonitor", "DeadlinePolicy"]
