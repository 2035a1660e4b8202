"""The simulator's run configuration.

Port of ``repro/sim/cluster.py`` as far as ``SimConfig``: the typed
configuration ``RunSpec.sim_config()`` returns, which the train driver's
``predicted`` block, the tuner and the watchdog read (through
``sim/replay.predict_step``). The event-loop engines (``simulate``,
``StepRecord``, ``SimResult``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.sim.workers import ComputeModel


@dataclasses.dataclass
class SimConfig:
    p: int
    d: int = 1_000_000
    method: str = "gs-sgd"
    buckets: int = 1
    steps: int = 100
    k: int | None = None
    rows: int | str = 5
    width: int | None = None
    shape: str | None = None          # collective shape (None = per-method)
    wire_dtype_bytes: int = 4         # sketch wire bytes/elt (bf16 = 2)
    topology: str = "flat"            # 'flat' | 'hier' network
    link: str = "1gbe"
    intra_link: str = "ici"
    group_size: int = 8
    overlap: bool = True
    bwd_chunks: int = 1               # backward-interleaved readiness chunks
    fuse_encode: bool = False         # fragment-wise encode in the interleave
    bwd_frac: float = 2 / 3           # backward share of a step's compute
    compute: ComputeModel = dataclasses.field(default_factory=ComputeModel)
    heartbeat_timeout: float = 1.0    # seconds of silence before dead
    drop_stragglers: bool = True
    deadline_factor: float = 3.0
    max_drop_frac: float = 0.25
    participation: float | None = None  # per-step cohort fraction (None=all)
    rescale_lr: bool = True
    slow_workers: dict[int, float] = dataclasses.field(default_factory=dict)
    seed: int = 0
