"""repro_torch.runtime — elastic membership and heartbeat failure
detection (port of ``repro/runtime``; the straggler policy is not ported
yet)."""

from repro_torch.runtime.elastic import ElasticPlan, initial_plan, replan
from repro_torch.runtime.heartbeat import HeartbeatMonitor

__all__ = ["ElasticPlan", "initial_plan", "replan", "HeartbeatMonitor"]
