"""repro_torch.api — the typed run spec and its generated CLI flags."""

from repro_torch.api.cli import add_spec_args, apply_args
from repro_torch.api.spec import (SCHEMA, SIM_METHODS, ClusterSpec,
                                  ExchangeSpec, RunSpec, SketchSpec,
                                  WatchSpec, default_geometry)

__all__ = ["SCHEMA", "SIM_METHODS", "ClusterSpec", "ExchangeSpec", "RunSpec",
           "SketchSpec", "WatchSpec", "add_spec_args", "apply_args",
           "default_geometry"]
