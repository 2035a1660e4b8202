"""repro_torch.api — the typed run spec, train surface.

Port of ``repro/api/spec.py``: ``SketchSpec``, ``ExchangeSpec``,
``ClusterSpec``, ``WatchSpec`` and ``RunSpec`` with the same fields,
defaults, CLI metadata and JSON schema (``repro.api/runspec@1``), so a
spec file drives either package. ``default_geometry`` — the paper-regime
sketch-geometry rule the reference keeps in ``repro/sim/replay.py`` —
lives here, beside the one spec that resolves through it
(``sim/replay.py`` re-exports it).

``RunSpec`` converts into the other surfaces' objects as the reference's
does: ``sim_config()`` -> ``sim.SimConfig``, ``env()`` -> ``tune.Env``,
``cluster.network()`` -> the modeled network. The reference's ``serve``
block is carried through JSON untouched (serving is not ported yet).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

SCHEMA = "repro.api/runspec@1"

_UNSET = object()

WIRE_DTYPES = {"float32": 4, "bfloat16": 2, "float16": 2}
SHAPES = ("tree", "ring", "hier", "ps")

# Methods the simulator's ExchangeReplay can price ('none' maps to dense).
SIM_METHODS = ("gs-sgd", "gtopk", "sketched-sgd", "dense")
TOPOLOGIES = ("flat", "hier")
LINKS = ("1gbe", "10gbe", "ici")


def _field(default=_UNSET, *flags, parse=None, const=_UNSET, choices=None,
           help="", surfaces=(), metavar=None, dest=None, factory=None):
    """Declare a spec field once: default + flag names + type + help."""
    meta = {}
    if flags:
        meta["cli"] = {"flags": flags, "parse": parse, "const": const,
                       "choices": choices, "help": help,
                       "surfaces": tuple(surfaces), "metavar": metavar,
                       "dest": dest}
    if factory is not None:
        return dataclasses.field(default_factory=factory, metadata=meta)
    return dataclasses.field(default=default, metadata=meta)


def coerce_rows(v) -> int | str:
    """Sketch depth: an int, a numeric string (the CLI path), or 'log'."""
    if isinstance(v, str):
        if v == "log":
            return v
        try:
            v = int(v)
        except ValueError:
            raise ValueError(
                f"rows must be a positive int or 'log', got {v!r}") from None
    if not isinstance(v, int) or isinstance(v, bool) or v < 1:
        raise ValueError(f"rows must be a positive int or 'log', got {v!r}")
    return int(v)


EXPLICIT_NONE = type("ExplicitNone", (), {"__repr__": lambda s: "none"})()


def parse_opt_int(s: str):
    return EXPLICIT_NONE if s.lower() in ("none", "") else int(s)


def parse_opt_str(s: str):
    return EXPLICIT_NONE if s.lower() in ("none", "") else s


def parse_opt_float(s: str):
    return EXPLICIT_NONE if s.lower() in ("none", "") else float(s)


def parse_slow_workers(s: str) -> dict[int, float]:
    """``'ID:FACTOR,ID:FACTOR'`` -> {worker_id: slowdown_factor}."""
    out: dict[int, float] = {}
    for part in filter(None, s.split(",")):
        try:
            wid, factor = part.split(":")
            out[int(wid)] = float(factor)
        except ValueError:
            raise ValueError(
                f"--slow-workers expects 'ID:FACTOR,...', got {part!r}"
            ) from None
    return out


def default_geometry(d: int, *, k: int | None = None,
                     rows: int | str = "log",
                     width: int | None = None) -> tuple[int, int, int]:
    """(k, rows, width) for a given d — paper-regime defaults.

    k: 0.4% of d (Sec. IV-A final density). rows: 'log' scales the sketch
    depth O(log d); an int pins it. width: ~k/2 rounded to a power of two.
    """
    k = k or max(64, int(0.004 * d))
    if rows == "log":
        rows = max(3, math.ceil(math.log2(max(d, 2))))
    width = width or (1 << max(8, (k // 2 - 1).bit_length()))
    return int(k), int(rows), int(width)


def check_exchange_config(*, microbatch: int | None = None,
                          bwd_chunks: int | None = None,
                          fuse_encode: bool = False,
                          compressor: str = "gs-sgd",
                          buckets: int | None = None,
                          overlap: bool = True) -> None:
    """The step-config constraints every surface enforces identically."""
    if bwd_chunks is not None and microbatch is not None:
        raise ValueError("bwd_chunks interleaves the exchange with ONE "
                         "backward pass; combining it with microbatch "
                         "accumulation is not supported")
    if fuse_encode:
        if compressor != "gs-sgd":
            raise ValueError(
                "fuse_encode fragments the count-sketch encode by "
                "linearity, which only the gs-sgd compressor supports; "
                f"got compressor {compressor!r}")
        if buckets is None or bwd_chunks is None or not overlap:
            raise ValueError(
                "fuse_encode needs the backward-interleaved exchange: "
                "set buckets and bwd_chunks and keep overlap enabled")


def _arch_choices():
    from repro_torch.configs import ARCHS
    return list(ARCHS)


def _compressor_choices():
    from repro_torch.core.compression import REGISTRY
    return sorted(REGISTRY) + ["none"]


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Count-sketch geometry. ``k=None``/``width=None`` derive from d via
    ``default_geometry``; ``rows`` may be ``'log'``."""

    rows: int | str = _field(
        5, "--rows", parse=coerce_rows, surfaces=("train", "sim"),
        help="count-sketch depth: an int, or 'log' for O(log d)")
    width: int | None = _field(
        16384, "--width", parse=parse_opt_int, surfaces=("train", "sim"),
        help="count-sketch row width ('none' = derive ~k/2 from d)")
    k: int | None = _field(
        None, "--k", parse=parse_opt_int, surfaces=("train", "sim"),
        help="top-k recovered per step ('none' = 0.4%% of d, Sec. IV-A)")
    seed: int = _field(
        0, "--sketch-seed", parse=int, surfaces=("train", "sim"),
        dest="sketch_seed", help="count-sketch hash seed")

    def __post_init__(self):
        object.__setattr__(self, "rows", coerce_rows(self.rows))
        for f in ("width", "k"):
            v = getattr(self, f)
            if v is not None:
                if int(v) < 1:
                    raise ValueError(f"{f} must be >= 1, got {v}")
                object.__setattr__(self, f, int(v))

    def resolve(self, d: int) -> "SketchSpec":
        """All-int geometry for a flat gradient of dimension ``d``."""
        k, rows, width = default_geometry(int(d), k=self.k, rows=self.rows,
                                          width=self.width)
        return dataclasses.replace(self, k=k, rows=rows, width=width)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SketchSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """One gradient exchange: compressor + schedule + wire knobs."""

    compressor: str = _field(
        "gs-sgd", "--compressor", "--method", choices=_compressor_choices,
        surfaces=("train", "sim"),
        help="gradient compressor ('none'/'dense' = uncompressed baseline)")
    buckets: int | None = _field(
        None, "--buckets", parse=parse_opt_int, surfaces=("train", "sim"),
        help="bucketed exchange: ~N buckets split at FlatSpec segment "
             "boundaries ('none' = monolithic)")
    overlap: bool = _field(
        True, "--no-overlap", const=False, surfaces=("train", "sim"),
        dest="overlap",
        help="disable the pipelined bucket schedule (sequential exchange)")
    bwd_chunks: int | None = _field(
        None, "--bwd-chunks", parse=parse_opt_int, surfaces=("train", "sim"),
        help="split the backward into K autodiff chunks ('none' = "
             "monolithic backward)")
    fuse_encode: bool = _field(
        False, "--fuse-encode", const=True, surfaces=("train", "sim"),
        dest="fuse_encode",
        help="fuse the count-sketch encode into the backward-interleaved "
             "pipeline")
    microbatch: int | None = _field(
        None, "--microbatch", parse=parse_opt_int, surfaces=("train", "tune"),
        help="per-device rows per gradient-accumulation slice")
    shape: str | None = _field(
        None, "--shape", parse=parse_opt_str, surfaces=("sim",),
        help="collective shape override (simulator-only)")
    wire_dtype: str = _field(
        "float32", "--wire-dtype", choices=tuple(WIRE_DTYPES),
        surfaces=("train", "sim"),
        help="sketch dtype on the wire (bfloat16 halves collective bytes)")
    allreduce_mode: str = _field(
        "psum", "--allreduce-mode", choices=("psum", "tree"),
        surfaces=("train",),
        help="sketch all-reduce: psum | tree (faithful Alg. 1)")
    sketch: SketchSpec = _field(factory=SketchSpec)

    def validate(self) -> None:
        if self.compressor not in _compressor_choices():
            raise ValueError(
                f"unknown compressor {self.compressor!r}; choose from "
                f"{_compressor_choices()}")
        for f in ("buckets", "bwd_chunks", "microbatch"):
            v = getattr(self, f)
            if v is not None and v < 1:
                raise ValueError(f"{f} must be >= 1, got {v}")
        if self.shape is not None and self.shape not in SHAPES:
            raise ValueError(f"unknown collective shape {self.shape!r}; "
                             f"choose from {SHAPES}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}; "
                             f"choose from {tuple(WIRE_DTYPES)}")
        if self.wire_dtype != "float32" and self.compressor != "gs-sgd":
            raise ValueError(
                f"wire_dtype {self.wire_dtype!r} is only supported by the "
                f"gs-sgd compressor, not {self.compressor!r}")
        if self.allreduce_mode not in ("psum", "tree"):
            raise ValueError(
                f"unknown allreduce_mode {self.allreduce_mode!r}")
        check_exchange_config(microbatch=self.microbatch,
                              bwd_chunks=self.bwd_chunks,
                              fuse_encode=self.fuse_encode,
                              compressor=self.compressor,
                              buckets=self.buckets,
                              overlap=self.overlap)

    def compressor_kw(self, d: int) -> dict:
        """The ``compression.make`` kwargs this spec resolves to at d."""
        if self.compressor in ("dense", "none"):
            return {}
        sk = self.sketch.resolve(d)
        kw: dict[str, Any] = {"k": sk.k, "rows": sk.rows, "width": sk.width,
                              "seed": sk.seed}
        if self.compressor == "gs-sgd":
            import torch
            kw["allreduce_mode"] = self.allreduce_mode
            kw["wire_dtype"] = {"float32": torch.float32,
                                "bfloat16": torch.bfloat16,
                                "float16": torch.float16}[self.wire_dtype]
        return kw

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ExchangeSpec":
        d = dict(d or {})
        d["sketch"] = SketchSpec.from_json(d.get("sketch") or {})
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Worker count, network topology/link regimes, heterogeneous slow
    workers, the fault policy, and the per-step compute model.

    ``link_alpha``/``link_beta`` are calibrated Eq. 1 overrides for the
    (inter-group, on 'hier') link — ``None`` keeps the named preset; the
    tuner's trace calibration writes them (no CLI flag on purpose).
    """

    p: int = _field(
        4, "--workers", "--p", parse=int,
        surfaces=("train", "sim", "tune"), dest="workers",
        help="worker count (the data-parallel degree)")
    topology: str = _field(
        "flat", "--topology", choices=TOPOLOGIES, surfaces=("sim", "tune"),
        help="network topology")
    link: str = _field(
        "1gbe", "--link", choices=LINKS, surfaces=("sim", "tune"),
        help="(inter-group) link preset")
    intra_link: str = _field(
        "ici", "--intra-link", choices=LINKS, surfaces=("sim", "tune"),
        help="intra-group link preset (hier topology)")
    group_size: int = _field(
        8, "--group-size", parse=int, surfaces=("sim", "tune"),
        help="workers per group (hier topology)")
    slow_workers: dict[int, float] = _field(
        None, "--slow-workers", parse=parse_slow_workers, surfaces=("sim",),
        metavar="ID:FACTOR,...", factory=dict,
        help="heterogeneous per-worker link slowdowns, e.g. '3:10,7:2.5'")
    heartbeat_timeout: float = _field(
        1.0, "--heartbeat-timeout", parse=float, surfaces=("sim",),
        help="seconds of heartbeat silence before a worker is dead")
    drop_stragglers: bool = _field(
        True, "--no-drop-stragglers", const=False, surfaces=("sim",),
        dest="drop_stragglers",
        help="disable the DeadlinePolicy straggler drop")
    deadline_factor: float = _field(
        3.0, "--deadline-factor", parse=float, surfaces=("sim",),
        help="straggler deadline as a multiple of the median step")
    max_drop_frac: float = _field(
        0.25, "--max-drop-frac", parse=float, surfaces=("sim",),
        help="max fraction of workers the straggler policy may drop")
    participation: float | None = _field(
        None, "--participation", parse=parse_opt_float,
        surfaces=("sim", "tune"), metavar="FRAC",
        help="per-step client participation fraction in (0, 1] ('none' = "
             "full participation)")
    mem_gb: float = _field(
        16.0, "--mem-gb", parse=float, surfaces=("serve",),
        help="per-device memory budget (GB) of the serving KV-cache pool")
    rescale_lr: bool = True
    compute_mean: float = _field(
        0.1, "--compute-mean", parse=float, surfaces=("sim", "tune"),
        help="mean seconds of fwd+bwd per step")
    compute_jitter: float = _field(
        0.08, "--compute-jitter", parse=float, surfaces=("sim",),
        help="coefficient of variation of per-worker step times")
    bwd_frac: float = _field(
        2 / 3, "--bwd-frac", parse=float, surfaces=("sim", "tune"),
        help="backward share of per-step compute (readiness clock)")
    link_alpha: float | None = None
    link_beta: float | None = None

    def __post_init__(self):
        sw = self.slow_workers or {}
        object.__setattr__(self, "slow_workers",
                           {int(k): float(v) for k, v in sw.items()})

    def validate(self) -> None:
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}; "
                             f"choose from {TOPOLOGIES}")
        for f in ("link", "intra_link"):
            if getattr(self, f) not in LINKS:
                raise ValueError(f"unknown {f} {getattr(self, f)!r}; "
                                 f"choose from {LINKS}")
        if self.group_size < 1:
            raise ValueError(f"group_size must be >= 1, got "
                             f"{self.group_size}")
        for w, factor in self.slow_workers.items():
            if factor <= 0:
                raise ValueError(f"slow-worker factor for worker {w} must "
                                 f"be > 0, got {factor}")
        if not (self.mem_gb > 0 and math.isfinite(self.mem_gb)):
            raise ValueError(f"mem_gb must be a positive finite number, "
                             f"got {self.mem_gb}")
        if self.participation is not None and not (
                0.0 < self.participation <= 1.0):
            raise ValueError(f"participation must be in (0, 1], got "
                             f"{self.participation}")

    def link_spec(self):
        """Eq. 1 LinkSpec for the (inter-group) link, calibrated overrides
        applied over the named preset."""
        from repro_torch.sim.network import PRESETS, LinkSpec
        base = PRESETS[self.link]
        if self.link_alpha is None and self.link_beta is None:
            return base
        return LinkSpec(
            alpha=base.alpha if self.link_alpha is None else self.link_alpha,
            beta=base.beta if self.link_beta is None else self.link_beta)

    def network(self):
        """The modeled network, including calibration and slow workers."""
        from repro_torch.sim.network import make_network
        return make_network(self.topology, link=self.link_spec(),
                            group_size=self.group_size, intra=self.intra_link,
                            slow_workers=self.slow_workers)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ClusterSpec":
        return cls(**(d or {}))


@dataclasses.dataclass(frozen=True)
class WatchSpec:
    """The drift watchdog: a streaming ``obs.drift.DriftDetector`` over
    per-step records, a calibration refit on a trailing window, and a
    budgeted tuner re-plan applied at the next step boundary
    (``tune/watch.py``). ``delta``/``threshold`` are the Page-Hinkley
    slack and alarm level on *relative* per-phase residuals."""

    enabled: bool = _field(
        False, "--watch", const=True, surfaces=("train", "sim"),
        dest="watch",
        help="stream per-step records through the drift watchdog: detect "
             "sustained per-phase drift, refit calibration on a trailing "
             "window, re-plan with the tuner, apply at the next step "
             "boundary")
    warmup: int = _field(
        5, "--drift-warmup", parse=int, surfaces=("train", "sim"),
        help="steps averaged into the frozen per-phase baseline before "
             "the change test arms (re-arms after every re-plan)")
    delta: float = _field(
        0.1, "--drift-delta", parse=float, surfaces=("train", "sim"),
        help="Page-Hinkley slack: relative per-step deviation ignored by "
             "the drift test")
    threshold: float = _field(
        1.5, "--drift-threshold", parse=float, surfaces=("train", "sim"),
        help="Page-Hinkley alarm threshold on accumulated relative excess")
    window: int = _field(
        8, "--drift-window", parse=int, surfaces=("train", "sim"),
        help="trailing post-onset records the calibration refit uses")
    replan_budget: int = _field(
        16, "--replan-budget", parse=int, surfaces=("train", "sim"),
        help="max tuner candidates evaluated per re-plan")

    def validate(self) -> None:
        if self.warmup < 1:
            raise ValueError(f"drift warmup must be >= 1, got {self.warmup}")
        if self.threshold < 0:
            raise ValueError(
                f"drift threshold must be >= 0, got {self.threshold}")
        for f in ("window", "replan_budget"):
            if getattr(self, f) < 1:
                raise ValueError(
                    f"watch {f} must be >= 1, got {getattr(self, f)}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "WatchSpec":
        # spec JSONs without a "watch" block: all defaults
        return cls(**(d or {}))


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything one training run needs."""

    arch: str = _field(
        "qwen3-4b", "--arch", choices=_arch_choices,
        surfaces=("train", "sim", "tune", "serve"), help="model architecture")
    smoke: bool = _field(
        False, "--smoke", const=True,
        surfaces=("train", "sim", "tune", "serve"),
        dest="smoke", help="use the reduced same-family config")
    d: int | None = _field(
        None, "--d", parse=parse_opt_int, surfaces=("sim", "tune"),
        help="flat gradient dimension override")
    steps: int = _field(
        50, "--steps", parse=int, surfaces=("train", "sim"),
        help="training / simulated steps")
    batch: int = _field(
        8, "--batch", parse=int, surfaces=("train",), help="global batch")
    seq: int = _field(
        64, "--seq", parse=int, surfaces=("train",), help="sequence length")
    lr: float = _field(
        1e-3, "--lr", parse=float, surfaces=("train",), help="learning rate")
    optimizer: str | None = _field(
        None, "--optimizer", parse=parse_opt_str, surfaces=("train",),
        help="optimizer name ('none' = per-arch default)")
    seed: int = _field(
        0, "--seed", parse=int, surfaces=("train", "sim", "tune", "serve"),
        help="run seed (data stream, init)")
    remat: bool = _field(
        True, "--no-remat", const=False, surfaces=("train",), dest="remat",
        help="disable remat (a numerical no-op in the port)")
    ckpt_dir: str | None = _field(
        None, "--ckpt-dir", parse=parse_opt_str, surfaces=("train",),
        help="checkpoint directory ('none' = no checkpoints)")
    ckpt_every: int = _field(
        20, "--ckpt-every", parse=int, surfaces=("train",),
        help="checkpoint cadence in steps")
    trace: str | None = _field(
        None, "--trace", parse=parse_opt_str, surfaces=("train", "sim"),
        metavar="PATH",
        help="write a Chrome/Perfetto span trace of the run here "
             "(repro_torch.obs; 'none' = tracing off)")
    exchange: ExchangeSpec = _field(factory=ExchangeSpec)
    cluster: ClusterSpec = _field(factory=ClusterSpec)
    watch: WatchSpec = _field(factory=WatchSpec)
    serve: dict | None = None   # reference's ServeSpec block, carried as-is

    def validate(self) -> None:
        for f in ("steps", "batch", "seq", "ckpt_every"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if self.d is not None and self.d < 1:
            raise ValueError(f"d must be >= 1, got {self.d}")
        self.exchange.validate()
        self.cluster.validate()
        self.watch.validate()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if d["serve"] is None:
            del d["serve"]
        return {"schema": SCHEMA, **d}

    @classmethod
    def from_json(cls, d: dict) -> "RunSpec":
        d = dict(d)
        schema = d.pop("schema", SCHEMA)
        if schema != SCHEMA:
            raise ValueError(f"not a {SCHEMA} document: schema={schema!r}")
        d["exchange"] = ExchangeSpec.from_json(d.get("exchange") or {})
        d["cluster"] = ClusterSpec.from_json(d.get("cluster") or {})
        d["watch"] = WatchSpec.from_json(d.get("watch") or {})
        return cls(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "RunSpec":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def arch_config(self):
        from repro_torch.configs import ARCHS, SMOKES
        return (SMOKES if self.smoke else ARCHS)[self.arch]

    def mesh_axes(self):
        from repro_torch.core.gs_sgd import MeshAxes
        p = self.cluster.p
        return MeshAxes(tp=1, data=p, tp_axis=None,
                        data_axis="data" if p > 1 else None)

    def resolve_d(self) -> int:
        """Flat gradient dimension, exactly as train would see it."""
        if self.d is not None:
            return int(self.d)
        from repro_torch.core.gs_sgd import local_seg_shapes
        from repro_torch.models.flatten import make_flat_spec
        shapes = local_seg_shapes(make_flat_spec(self.arch_config(), 1),
                                  self.mesh_axes(), "dp")
        return sum(math.prod(s) for s in shapes.values())

    def make_optimizer(self):
        from repro_torch.configs import TRAIN_OVERRIDES
        from repro_torch.optim import make as make_opt
        ov = TRAIN_OVERRIDES.get(self.arch_config().name, {})
        return make_opt(self.optimizer or ov.get("optimizer", "adamw"),
                        lr=self.lr)

    def make_train_step(self, opt=None, dtype=None, device=None):
        """Spec-first train-step construction (the CLI's build path). Every
        arch, smoke or full size, runs in 'dp' on the simulated workers,
        as the reference's ``RunSpec`` builds it (``configs.DP_MODE`` is
        the production policy, which this path does not consult)."""
        import torch

        from repro_torch.core.gs_sgd import make_train_step
        return make_train_step(
            self.arch_config(), self.mesh_axes(),
            opt if opt is not None else self.make_optimizer(),
            dp_mode="dp", spec=self.exchange, remat=self.remat,
            dtype=dtype if dtype is not None else torch.float32,
            device=device)

    def sim_config(self):
        """``sim.SimConfig`` with all-int geometry (rows/width/k resolved
        through the one ``SketchSpec`` table)."""
        from repro_torch.sim.cluster import SimConfig
        from repro_torch.sim.workers import ComputeModel
        ex, cl = self.exchange, self.cluster
        method = "dense" if ex.compressor == "none" else ex.compressor
        if method not in SIM_METHODS:
            raise ValueError(
                f"compressor {ex.compressor!r} is not replayable by the "
                f"simulator; choose from {SIM_METHODS + ('none',)}")
        d = self.resolve_d()
        sk = ex.sketch.resolve(d)
        return SimConfig(
            p=cl.p, d=d, method=method, buckets=ex.buckets or 1,
            steps=self.steps, k=sk.k, rows=sk.rows, width=sk.width,
            shape=ex.shape, topology=cl.topology, link=cl.link,
            intra_link=cl.intra_link, group_size=cl.group_size,
            overlap=ex.overlap, bwd_chunks=ex.bwd_chunks or 1,
            fuse_encode=ex.fuse_encode, bwd_frac=cl.bwd_frac,
            compute=ComputeModel(mean=cl.compute_mean,
                                 jitter=cl.compute_jitter, seed=self.seed),
            heartbeat_timeout=cl.heartbeat_timeout,
            drop_stragglers=cl.drop_stragglers,
            deadline_factor=cl.deadline_factor,
            max_drop_frac=cl.max_drop_frac,
            participation=cl.participation, rescale_lr=cl.rescale_lr,
            slow_workers=dict(cl.slow_workers), seed=self.seed,
            wire_dtype_bytes=WIRE_DTYPES[ex.wire_dtype])

    def env(self):
        """``tune.Env`` — the tuner's fixed half — from this spec."""
        from repro_torch.tune.space import Env
        cl = self.cluster
        return Env(p=cl.p, d=self.resolve_d(), topology=cl.topology,
                   link=cl.link, intra_link=cl.intra_link,
                   group_size=cl.group_size, t_compute=cl.compute_mean,
                   bwd_frac=cl.bwd_frac, microbatch=self.exchange.microbatch,
                   fuse_encode=self.exchange.fuse_encode,
                   link_alpha=cl.link_alpha, link_beta=cl.link_beta,
                   participation=cl.participation)

    @classmethod
    def from_env(cls, env) -> "RunSpec":
        """The inverse of ``env()`` for plans tuned without a full spec:
        the cluster and exchange constraints carry over; arch-level fields
        keep defaults. ``fuse_encode`` is not carried back (a bare Env
        cannot express the buckets/bwd_chunks half validation needs)."""
        return cls(
            d=int(env.d),
            exchange=ExchangeSpec(microbatch=env.microbatch),
            cluster=ClusterSpec(
                p=int(env.p), topology=env.topology, link=env.link,
                intra_link=env.intra_link, group_size=int(env.group_size),
                compute_mean=float(env.t_compute),
                bwd_frac=float(env.bwd_frac),
                link_alpha=env.link_alpha, link_beta=env.link_beta,
                participation=env.participation))
