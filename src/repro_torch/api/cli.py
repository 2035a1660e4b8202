"""Argparse generation from the spec fields.

Port of ``repro/api/cli.py``: every flag comes from the one declaration
its field has in ``repro_torch.api.spec``. Generated flags parse with
``default=None`` ("not given"); ``apply_args`` lets explicitly-passed
flags override the base spec.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.api import spec as S

SPEC_TREE = (
    ((), S.RunSpec),
    (("exchange",), S.ExchangeSpec),
    (("exchange", "sketch"), S.SketchSpec),
    (("cluster",), S.ClusterSpec),
    (("watch",), S.WatchSpec),
)

SURFACES = ("train", "sim", "tune", "serve")


def iter_cli_fields():
    """Yield ``(path, field, cli_meta)`` for every flag-bearing spec field."""
    for path, cls in SPEC_TREE:
        for f in dataclasses.fields(cls):
            m = f.metadata.get("cli")
            if m is not None:
                yield path, f, m


def _dest(f, m) -> str:
    return m["dest"] or f.name


def _default_of(f):
    if f.default is not dataclasses.MISSING and f.default is not S._UNSET:
        return f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore
        return f.default_factory()  # type: ignore
    return None


def add_spec_args(ap: argparse.ArgumentParser, surface: str) -> None:
    """Add one surface's generated flags (defaults parse as None)."""
    if surface not in SURFACES:
        raise ValueError(f"unknown surface {surface!r}")
    for path, f, m in iter_cli_fields():
        if surface not in m["surfaces"]:
            continue
        default = _default_of(f)
        help_txt = f"{m['help']} [default: {default}]"
        if m["const"] is not S._UNSET:
            ap.add_argument(*m["flags"], dest=_dest(f, m),
                            action="store_const", const=m["const"],
                            default=None, help=help_txt)
            if isinstance(m["const"], bool):
                flag = m["flags"][0]
                inv = ("--" + flag[5:] if flag.startswith("--no-")
                       else "--no-" + flag[2:])
                ap.add_argument(inv, dest=_dest(f, m),
                                action="store_const", const=not m["const"],
                                default=None, help=f"inverse of {flag}")
            continue
        choices = m["choices"]
        if callable(choices):
            choices = choices()
        ap.add_argument(*m["flags"], dest=_dest(f, m),
                        type=m["parse"] or str, choices=choices,
                        default=None, metavar=m["metavar"], help=help_txt)


def _replace_path(spec, path: tuple, name: str, value):
    if not path:
        return dataclasses.replace(spec, **{name: value})
    inner = getattr(spec, path[0])
    return dataclasses.replace(
        spec, **{path[0]: _replace_path(inner, path[1:], name, value)})


def apply_args(base: "S.RunSpec", args: argparse.Namespace,
               surface: str) -> "S.RunSpec":
    """Every flag the user actually passed overrides ``base``."""
    spec = base
    for path, f, m in iter_cli_fields():
        if surface not in m["surfaces"]:
            continue
        v = getattr(args, _dest(f, m), None)
        if v is None:
            continue
        if v is S.EXPLICIT_NONE:
            v = None
        spec = _replace_path(spec, path, f.name, v)
    return spec
