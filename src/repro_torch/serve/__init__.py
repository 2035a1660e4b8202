"""repro_torch.serve — continuous-batching serving engine (port of
``repro/serve``).

Layers:

    kvcache   — paged / contiguous KV-cache backends over the model's
                ``init_cache`` layout (free-list allocator, block tables)
    scheduler — continuous-batching engine: admit/evict mid-generation,
                deadline-aware admission priced by the cluster cost model
    streaming — per-request token generators + stop conditions
    replica   — multi-replica serving with heartbeat-driven failover
    loadtest  — seeded Poisson load test, CB against static batching

The engine is model-agnostic: anything exposing ``prefill_fn`` /
``decode_fn`` / ``init_cache`` (models/model.py) serves unchanged.
"""

from repro_torch.serve.kvcache import (ContiguousKVCache,  # noqa: F401
                                       OutOfBlocks, PagedKVCache)
from repro_torch.serve.scheduler import (Completion, Request,  # noqa: F401
                                         ServeEngine)
from repro_torch.serve.streaming import stream_tokens  # noqa: F401
from repro_torch.serve.replica import ReplicaSet  # noqa: F401
