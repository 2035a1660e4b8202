"""repro_torch.api — the typed run spec, train surface.

Port of ``repro/api/spec.py``: ``SketchSpec``, ``ExchangeSpec``,
``ClusterSpec`` and ``RunSpec`` with the same fields, defaults, CLI
metadata and JSON schema (``repro.api/runspec@1``), so a spec file drives
either package. ``default_geometry`` — the paper-regime sketch-geometry
rule the reference keeps in ``repro/sim/replay.py`` — lives here, beside
the one spec that resolves through it.

The reference's ``watch`` and ``serve`` blocks are carried through JSON
untouched (their surfaces are not ported yet); a spec that enables the
watchdog is refused by the train driver.
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
    """Worker count and the cluster model (the port's train surface reads
    ``p``; the rest is carried for spec-file parity)."""

    p: int = _field(
        4, "--workers", "--p", parse=int,
        surfaces=("train", "sim", "tune"), dest="workers",
        help="worker count (the data-parallel degree)")
    topology: str = "flat"
    link: str = "1gbe"
    intra_link: str = "ici"
    group_size: int = 8
    slow_workers: dict[int, float] = dataclasses.field(default_factory=dict)
    heartbeat_timeout: float = 1.0
    drop_stragglers: bool = True
    deadline_factor: float = 3.0
    max_drop_frac: float = 0.25
    participation: float | None = None
    mem_gb: float = 16.0
    rescale_lr: bool = True
    compute_mean: float = 0.1
    compute_jitter: float = 0.08
    bwd_frac: float = 2 / 3
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

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ClusterSpec":
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
        help="checkpoint directory (not ported yet: must stay 'none')")
    ckpt_every: int = _field(
        20, "--ckpt-every", parse=int, surfaces=("train",),
        help="checkpoint cadence in steps")
    trace: str | None = _field(
        None, "--trace", parse=parse_opt_str, surfaces=("train", "sim"),
        metavar="PATH", help="span trace path (not ported yet)")
    exchange: ExchangeSpec = _field(factory=ExchangeSpec)
    cluster: ClusterSpec = _field(factory=ClusterSpec)
    watch: dict | None = None   # reference's WatchSpec block, carried as-is
    serve: dict | None = None   # reference's ServeSpec block, carried as-is

    def validate(self) -> None:
        for f in ("steps", "batch", "seq", "ckpt_every"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if self.d is not None and self.d < 1:
            raise ValueError(f"d must be >= 1, got {self.d}")
        self.exchange.validate()
        self.cluster.validate()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for blk in ("watch", "serve"):
            if d[blk] is None:
                del d[blk]
        return {"schema": SCHEMA, **d}

    @classmethod
    def from_json(cls, d: dict) -> "RunSpec":
        d = dict(d)
        schema = d.pop("schema", SCHEMA)
        if schema != SCHEMA:
            raise ValueError(f"not a {SCHEMA} document: schema={schema!r}")
        d["exchange"] = ExchangeSpec.from_json(d.get("exchange") or {})
        d["cluster"] = ClusterSpec.from_json(d.get("cluster") or {})
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
        """Spec-first train-step construction (the CLI's build path). A
        full-size arch runs in its production data-axis mode
        (``configs.DP_MODE``: yi-9b's fsdp is not ported, so it raises);
        smoke configs run in dp."""
        import torch

        from repro_torch.configs import DP_MODE
        from repro_torch.core.gs_sgd import make_train_step
        dp_mode = "dp" if self.smoke else DP_MODE.get(self.arch, "dp")
        return make_train_step(
            self.arch_config(), self.mesh_axes(),
            opt if opt is not None else self.make_optimizer(),
            dp_mode=dp_mode, spec=self.exchange, remat=self.remat,
            dtype=dtype if dtype is not None else torch.float32,
            device=device)
