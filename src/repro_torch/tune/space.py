"""The joint configuration space of the gs-SGD exchange pipeline.

Port of ``repro/tune/space.py`` (pure Python over the port's spec and
sim layers).

A tuning problem splits into a fixed half and a searched half:

``Env``        — the cluster/model/hardware the user cannot change per run:
                 worker count P, flat gradient dimension d, topology and
                 link regime (optionally CALIBRATED alpha/beta from a
                 measured trace — see ``calibrate.py``), per-step compute
                 time, the backward share of it, and whether the step uses
                 microbatch accumulation (which the runtime forbids to
                 combine with backward chunking).
``Candidate``  — one point of the searched half: method, bucket count,
                 backward-interleave chunks, sketch rows/width, top-k
                 fraction, collective shape.
``SearchSpace``— axis-aligned grids of candidates, enumerated in a
                 deterministic order (the tuner's determinism guarantee
                 starts here).

Validation reuses the RUNTIME's own constructors: ``validate`` builds the
candidate's real ``ExchangeReplay`` (which builds the real
``compression.bucketize`` geometry, including the ``_scale_bucket`` k/width
clamps) and calls the same ``ExchangeSpec.validate`` that
``make_train_step`` raises through — so the searcher skips exactly the
combos the runtime would reject, with the runtime's own error message as
the skip reason, instead of crashing mid-sweep.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.api import ExchangeSpec, RunSpec, SketchSpec
from repro_torch.sim.network import LinkSpec, NetworkModel
from repro_torch.sim.replay import ExchangeReplay


@dataclasses.dataclass(frozen=True)
class Env:
    """Fixed half of a tuning problem (see module docstring).

    ``link_alpha`` / ``link_beta``: calibrated Eq. 1 overrides for the
    (inter-group, on 'hier') link — ``None`` keeps the named preset. Set
    them via ``calibrate.Calibration.apply`` to anchor predictions to a
    measured trace.
    """

    p: int
    d: int
    topology: str = "flat"            # 'flat' | 'hier'
    link: str = "1gbe"                # preset name (PRESETS)
    intra_link: str = "ici"
    group_size: int = 8
    t_compute: float = 0.1            # seconds of fwd+bwd per step
    bwd_frac: float = 2 / 3           # backward share of t_compute
    microbatch: int | None = None     # runtime accumulation (constrains space)
    fuse_encode: bool = False         # price the fused-encode interleave
    link_alpha: float | None = None   # calibrated Eq. 1 startup (s)
    link_beta: float | None = None    # calibrated Eq. 1 inverse bw (s/B)
    participation: float | None = None  # per-step cohort fraction (None=all)

    def link_spec(self) -> LinkSpec:
        # single source: the spec layer's calibrated-override-over-preset
        # merge (a second copy here would silently diverge)
        return RunSpec.from_env(self).cluster.link_spec()

    def network(self) -> NetworkModel:
        return RunSpec.from_env(self).cluster.network()

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Env":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One searched configuration. Defaults are the CLI defaults — the
    all-defaults candidate is the un-tuned baseline every sweep compares
    against (a budgeted sweep always keeps it)."""

    method: str = "gs-sgd"
    buckets: int = 1
    bwd_chunks: int = 1
    rows: int | str = 5               # sketch depth; 'log' = O(log d)
    width: int | None = None          # sketch row width (None = default)
    k_frac: float | None = None       # top-k as a fraction of d (None = 0.4%)
    shape: str | None = None          # collective shape (None = per-method)

    def k(self, d: int) -> int | None:
        if self.k_frac is None:
            return None
        return max(1, int(self.k_frac * d))

    def key(self) -> tuple:
        """Canonical total order — the deterministic tie-breaker."""
        return (self.method, self.buckets, self.bwd_chunks, str(self.rows),
                -1 if self.width is None else self.width,
                -1.0 if self.k_frac is None else self.k_frac,
                self.shape or "")

    def label(self) -> str:
        bits = [self.method, f"b{self.buckets}", f"K{self.bwd_chunks}",
                f"r{self.rows}"]
        if self.width is not None:
            bits.append(f"w{self.width}")
        if self.k_frac is not None:
            bits.append(f"k{self.k_frac:g}")
        if self.shape is not None:
            bits.append(self.shape)
        return "/".join(bits)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Candidate":
        return cls(**d)

    def exchange_spec(self, env: Env) -> ExchangeSpec:
        """This candidate as an ``ExchangeSpec`` delta over the env's
        constraints — the object the spec layer validates."""
        return ExchangeSpec(
            compressor=self.method, buckets=int(self.buckets),
            bwd_chunks=(int(self.bwd_chunks) if self.bwd_chunks > 1
                        else None),
            microbatch=env.microbatch, shape=self.shape,
            sketch=SketchSpec(rows=self.rows, width=self.width,
                              k=self.k(env.d)))

    def apply(self, spec: RunSpec, geometry: dict | None = None) -> RunSpec:
        """Apply this candidate as a delta onto a base ``RunSpec``.

        ``geometry`` (the searcher's resolved k/rows/width ints from the
        real replay build) pins the sketch so applying the result never
        re-derives anything; without it the candidate's own (possibly
        symbolic) values ride along. ``bwd_chunks=1`` maps to ``None``
        (monolithic backward — pinned bit-exact vs the readiness path at
        one chunk, and keeps plans applicable to microbatched runs)."""
        sk = spec.exchange.sketch
        if geometry is not None:
            sk = dataclasses.replace(sk, k=int(geometry["k"]),
                                     rows=int(geometry["rows"]),
                                     width=int(geometry["width"]))
        else:
            sk = dataclasses.replace(sk, rows=self.rows, width=self.width,
                                     k=self.k(spec.resolve_d()))
        ex = dataclasses.replace(
            spec.exchange, compressor=self.method, buckets=int(self.buckets),
            bwd_chunks=(int(self.bwd_chunks) if self.bwd_chunks > 1
                        else None),
            shape=self.shape, sketch=sk)
        return dataclasses.replace(spec, exchange=ex)


def _tup(xs) -> tuple:
    return tuple(xs)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Axis-aligned candidate grid. ``candidates()`` enumerates the cross
    product in a fixed axis order — same space, same order, every time."""

    methods: tuple = ("gs-sgd",)
    buckets: tuple = (1, 2, 4, 8)
    bwd_chunks: tuple = (1, 2, 4)
    rows: tuple = (5,)
    widths: tuple = (None,)
    k_fracs: tuple = (None,)
    shapes: tuple = (None,)

    @property
    def size(self) -> int:
        n = 1
        for ax in (self.methods, self.buckets, self.bwd_chunks, self.rows,
                   self.widths, self.k_fracs, self.shapes):
            n *= len(ax)
        return n

    def candidates(self):
        for m, b, kc, r, w, kf, sh in itertools.product(
                self.methods, self.buckets, self.bwd_chunks, self.rows,
                self.widths, self.k_fracs, self.shapes):
            yield Candidate(method=m, buckets=int(b), bwd_chunks=int(kc),
                            rows=r, width=w, k_frac=kf, shape=sh)

    def to_json(self) -> dict:
        return {k: list(v) for k, v in dataclasses.asdict(self).items()}

    @classmethod
    def from_json(cls, d: dict) -> "SearchSpace":
        return cls(**{k: _tup(v) for k, v in d.items()})


def validate(cand: Candidate, env: Env) -> ExchangeReplay:
    """Build the candidate's replay through the REAL runtime constructors.

    Raises ``ValueError`` exactly where the runtime would: the central
    ``repro_torch.api`` spec validation (the same ``ExchangeSpec.validate`` the
    CLIs and ``make_train_step`` raise through — microbatch + bwd_chunks,
    unknown methods/shapes), the ``ExchangeReplay``/collective-shape
    contracts (gTop-k is tree-only, Sketched-SGD is PS-only), and the
    staged-compressor requirement of the readiness interleave
    (``make_train_step`` silently falls back to the post-accumulation
    exchange for non-staged compressors, so crediting them with
    interleave savings would mis-rank the space).
    """
    cand.exchange_spec(env).validate()
    rep = ExchangeReplay(cand.method, env.d, buckets=cand.buckets,
                         k=cand.k(env.d), rows=cand.rows, width=cand.width,
                         shape=cand.shape, group_size=env.group_size)
    if cand.bwd_chunks > 1 and not all(
            hasattr(c, "stage_encode") for c in rep.bc.parts):
        raise ValueError(
            f"bwd_chunks={cand.bwd_chunks} needs the staged gs-sgd "
            f"compressor; the runtime runs {cand.method!r} through the "
            "post-accumulation exchange instead")
    return rep


def enumerate_valid(space: SearchSpace, env: Env
                    ) -> tuple[list[tuple[Candidate, ExchangeReplay]],
                               list[dict]]:
    """(valid (candidate, replay) pairs, skipped [{candidate, reason}]).

    Skips — never raises — on the runtime's own rejections, so one bad
    axis combination cannot kill a sweep.
    """
    valid, skipped = [], []
    for c in space.candidates():
        try:
            rep = validate(c, env)
        except (ValueError, AssertionError) as e:
            skipped.append({"candidate": c.to_json(), "reason": str(e)})
            continue
        valid.append((c, rep))
    return valid, skipped
