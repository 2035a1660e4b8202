"""``TunePlan`` — the serializable decision the tuner hands the launchers.

Port of ``repro/tune/plan.py``: the same schema (``repro.tune/plan@2``)
and the ``plan@1`` loader shim.

A plan is a JSON document built around ONE ``repro_torch.api.RunSpec``: the
tuned run configuration itself (cluster env + the chosen exchange config
with RESOLVED geometry — k/rows/width as plain ints, after
``default_geometry`` defaults — so applying a plan never re-derives
anything), plus the searched ``Candidate``, the predicted economics, the
ranked runners-up, what the searcher skipped and why, and provenance
(space + seed) sufficient to reproduce the search bit-for-bit.

Application is the spec layer's single path:

* ``repro_torch.launch.train --auto-tune PLAN.json`` merges
  ``plan.train_exchange()`` into its base spec — the very fields the
  manual CLI flags would set, so it is pinned bit-exact against passing
  ``plan.train_argv()`` by hand.
* ``plan.spec.sim_config()`` + ``plan.spec.cluster.network()`` carry the
  tuned exchange, the env's topology/link regime, AND any calibrated
  alpha/beta (which a preset name alone would silently lose) to the
  simulator (whose event-loop launcher is not ported yet).

Schema v2 (``repro.tune/plan@2``). v1 documents — which stored a tuner
``Env`` instead of a spec — still load through a shim, so pre-redesign
plans keep working with ``--auto-tune`` unchanged.
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.api import ExchangeSpec, RunSpec
from repro_torch.tune.space import Candidate, Env, SearchSpace

VERSION = 2
SCHEMA = "repro.tune/plan@2"
SCHEMA_V1 = "repro.tune/plan@1"


@dataclasses.dataclass(frozen=True)
class TunePlan:
    spec: RunSpec                  # the tuned run: env + resolved exchange
    choice: Candidate              # the searched delta that produced it
    geometry: dict                 # resolved ints: k, rows, width (+ buckets)
    predicted: dict                # CandidateCost.to_json() of the choice
    alternatives: list             # ranked top-N [{candidate, cost, geometry}]
    skipped: list                  # [{candidate, reason}] from enumeration
    provenance: dict               # {seed, space, n_valid, n_evaluated, ...}

    # -- serialization ------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA, "version": VERSION,
            "spec": self.spec.to_json(), "choice": self.choice.to_json(),
            "geometry": dict(self.geometry), "predicted": dict(self.predicted),
            "alternatives": list(self.alternatives),
            "skipped": list(self.skipped),
            "provenance": dict(self.provenance),
        }

    @classmethod
    def from_json(cls, d: dict) -> "TunePlan":
        schema = d.get("schema")
        if schema in (SCHEMA, SCHEMA_V1) and "choice" not in d:
            raise ValueError(f"plan document (schema {schema!r}) is "
                             "missing its 'choice'")
        choice = Candidate.from_json(d["choice"]) if "choice" in d else None
        if schema == SCHEMA:
            spec = RunSpec.from_json(d["spec"])
        elif schema == SCHEMA_V1:
            # pre-redesign plans stored a tuner Env + choice + geometry;
            # rebuild the equivalent RunSpec so application is identical
            env = Env.from_json(d["env"])
            spec = choice.apply(RunSpec.from_env(env),
                                geometry=d["geometry"])
        else:
            raise ValueError(f"not a {SCHEMA} (or {SCHEMA_V1}) document: "
                             f"schema={schema!r}")
        return cls(spec=spec, choice=choice,
                   geometry=d["geometry"], predicted=d["predicted"],
                   alternatives=d["alternatives"], skipped=d["skipped"],
                   provenance=d["provenance"])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "TunePlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- application --------------------------------------------------------

    @property
    def env(self) -> Env:
        """The tuner-facing view of the plan's cluster half (derived)."""
        return self.spec.env()

    def train_exchange(self, base: ExchangeSpec | None = None
                       ) -> ExchangeSpec:
        """The tuned exchange config merged over ``base`` — exactly the
        fields the manual train flags would set (compressor, buckets,
        bwd_chunks, resolved sketch), leaving driver-side knobs (overlap,
        microbatch, wire) to the caller's own spec.

        A tuned collective ``shape`` is a simulator-level knob with no
        training equivalent — applying such a plan to training would
        silently run economics the plan does not predict, so it is
        refused loudly instead (re-tune with ``shapes=(None,)`` for a
        trainable plan; ``simulate --plan`` applies the shape fine).
        """
        if self.choice.shape is not None:
            raise ValueError(
                f"plan tunes the collective shape ({self.choice.shape!r}),"
                " which the train driver cannot apply — re-tune with "
                "shapes=(None,) for a trainable plan, or use "
                "simulate --plan")
        ex = self.spec.exchange
        return dataclasses.replace(
            base if base is not None else ExchangeSpec(),
            compressor=ex.compressor, buckets=ex.buckets,
            bwd_chunks=ex.bwd_chunks, sketch=ex.sketch)

    def train_argv(self) -> list[str]:
        """The equivalent manual CLI flags (the bit-exactness pin's RHS)."""
        ex = self.train_exchange()
        argv = ["--compressor", ex.compressor,
                "--buckets", str(ex.buckets),
                "--k", str(ex.sketch.k), "--rows", str(ex.sketch.rows),
                "--width", str(ex.sketch.width),
                "--sketch-seed", str(ex.sketch.seed)]
        if ex.bwd_chunks is not None:
            argv += ["--bwd-chunks", str(ex.bwd_chunks)]
        return argv

    def summary(self) -> str:
        pr = self.predicted
        return (f"{self.choice.label()}  step {pr['step_time'] * 1e3:.2f}ms  "
                f"exposed comm {pr['exposed_comm'] * 1e3:.2f}ms  "
                f"err {pr['error_proxy']:.3f}  "
                f"compress x{pr['compression']:.0f}")


def from_search(env: Env, space: SearchSpace, ranked: list, skipped: list,
                *, seed: int, n_valid: int, error_probe: bool,
                probe_d: int, top: int,
                spec: RunSpec | None = None) -> TunePlan:
    """Assemble the plan from a ranked [(Candidate, CandidateCost,
    geometry)] list (best first). The winner is applied as a spec delta
    onto ``spec`` (or a ``RunSpec`` reconstructed from the env) with its
    resolved geometry; runners-up keep candidate + cost for the report."""
    if not ranked:
        raise ValueError("search produced no valid candidates "
                         f"({len(skipped)} skipped)")
    best, best_cost, best_geo = ranked[0]
    base = spec if spec is not None else RunSpec.from_env(env)
    alts = [{"candidate": c.to_json(), "cost": cc.to_json(),
             "geometry": dict(g)} for c, cc, g in ranked[1:top]]
    return TunePlan(
        spec=best.apply(base, geometry=best_geo), choice=best,
        geometry={"k": best_geo["k"], "rows": best_geo["rows"],
                  "width": best_geo["width"], "buckets": best_geo["buckets"],
                  "bucket_sizes": list(best_geo["bucket_sizes"])},
        predicted=best_cost.to_json(),
        alternatives=alts, skipped=list(skipped),
        provenance={"seed": seed, "space": space.to_json(),
                    "space_size": space.size, "n_valid": n_valid,
                    "n_evaluated": len(ranked),
                    "error_probe": bool(error_probe),
                    "probe_d": int(probe_d), "version": VERSION})
