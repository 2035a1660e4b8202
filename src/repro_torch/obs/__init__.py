"""repro_torch.obs — span tracing + metrics + provenance + drift detection.

Port of ``repro/obs``: the same schemas (``repro.obs/trace@1``,
``repro.tune/trace@2``, ``repro.obs/provenance@1``) and event layout.
"""

from repro_torch.obs import trace
from repro_torch.obs.drift import (DEFAULT_PHASES, DriftDetector, DriftEvent,
                                   detection_bound)
from repro_torch.obs.metrics import (TRACE2_SCHEMA, Metrics, dump,
                                     load_jsonl, trace2_doc)
from repro_torch.obs.provenance import provenance, runspec_hash
from repro_torch.obs.trace import (NULL, PHASES, TRACE_SCHEMA, Tracer,
                                   current, from_sim, validate)

__all__ = [
    "trace", "Tracer", "current", "from_sim", "validate", "NULL",
    "PHASES", "TRACE_SCHEMA", "TRACE2_SCHEMA", "Metrics", "trace2_doc",
    "dump", "load_jsonl", "provenance", "runspec_hash",
    "DEFAULT_PHASES", "DriftDetector", "DriftEvent", "detection_bound",
]
