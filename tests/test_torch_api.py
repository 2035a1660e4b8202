"""Port parity for the spec layer, the data stream, and the port's hygiene
rules (no JAX imports, no silent CPU fallback, no kernel fallback)."""

import ast
import os

import numpy as np
import pytest
import torch

from repro.api import RunSpec as JSpec
from repro.sim.replay import default_geometry as j_default_geometry
from repro_torch import api as tapi
from repro_torch.api import RunSpec as TSpec
from repro_torch.data import LMStream
from repro_torch.kernels import (build, heavymix_topk, sketch_decode,
                                 sketch_encode, ts_encode)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(ROOT, "examples", "specs", "qwen3_smoke.json")


@pytest.mark.parametrize("d", [1, 100, 12_345, 91_648, 1 << 22,
                               590_820_864, 3_000_000_000])
@pytest.mark.parametrize("rows,k,width", [("log", None, None),
                                          (5, None, None), (3, 256, 512)])
def test_default_geometry_pinned_to_reference(d, rows, k, width):
    assert tapi.default_geometry(d, k=k, rows=rows, width=width) == \
        j_default_geometry(d, k=k, rows=rows, width=width)


@pytest.mark.parametrize("d", [91_648, 590_820_864])
def test_sketch_resolve_matches(d):
    from repro.api import SketchSpec as JS
    for kw in ({}, {"rows": "log", "width": None}, {"width": None, "k": None}):
        assert tapi.SketchSpec(**kw).resolve(d).to_json() == \
            JS(**kw).resolve(d).to_json()


def test_spec_json_roundtrip_and_parity(tmp_path):
    t, j = TSpec.load(SPEC), JSpec.load(SPEC)
    tj, jj = t.to_json(), j.to_json()
    for key in tj:
        if key not in ("exchange", "cluster"):
            assert tj[key] == jj[key], key
    assert tj["exchange"] == jj["exchange"]
    assert {k: v for k, v in jj["cluster"].items() if k in tj["cluster"]} \
        == tj["cluster"]
    assert t.resolve_d() == j.resolve_d()
    path = tmp_path / "spec.json"
    t.save(str(path))
    assert TSpec.load(str(path)) == t
    # a spec dumped by the reference (with watch/serve blocks) loads too
    j.save(str(path))
    assert TSpec.load(str(path)).watch == jj["watch"]


def test_generated_flags_override_spec():
    import argparse
    ap = argparse.ArgumentParser()
    tapi.add_spec_args(ap, "train")
    args = ap.parse_args(["--workers", "3", "--buckets", "none", "--k", "7",
                          "--no-overlap", "--rows", "log"])
    spec = tapi.apply_args(TSpec.load(SPEC), args, "train")
    assert spec.cluster.p == 3 and spec.exchange.buckets is None
    assert spec.exchange.sketch.k == 7 and spec.exchange.overlap is False
    assert spec.exchange.sketch.rows == "log"


def test_lm_stream_shape_determinism_distribution():
    s = LMStream(vocab_size=256, seq_len=64, global_batch=32, seed=3)
    a, b = s.global_batch_at(5), s.global_batch_at(5)
    assert a["tokens"].shape == (32, 64) and a["labels"].shape == (32, 64)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], s.global_batch_at(6)["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    tok = a["tokens"]
    assert int(tok.min()) >= 0 and int(tok.max()) < 256
    follows = (a["labels"] == (tok * 31 + 17) % 256).float().mean()
    assert 0.85 < float(follows) < 0.95   # 10% noise (a few hit by chance)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_entry_points_refuse_silent_cpu(monkeypatch):
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.configs import SMOKES
    from repro_torch.launch import train
    from repro_torch.optim import make
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(SMOKES["qwen3-4b"], MeshAxes(tp=1, data=2,
                                                     tp_axis=None),
                        make("adamw"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--spec", SPEC, "--steps", "1"])


def _wrapper_calls():
    """One call of each kernel wrapper on tensors that lie on ``meta``."""
    from repro_torch.core.count_sketch import SketchConfig
    from repro_torch.core.ts_sketch import TSketchConfig
    cfg = SketchConfig(rows=3, width=256)
    meta = dict(device="meta")
    return {
        "sketch_encode": lambda: sketch_encode.sketch_encode(
            cfg, torch.empty(100, **meta)),
        "heavymix_scores": lambda: heavymix_topk.heavymix_scores(
            cfg, torch.empty((3, 256), **meta), torch.empty((), **meta),
            100),
        "sketch_decode": lambda: sketch_decode.sketch_decode(
            cfg, torch.empty((3, 256), **meta), 100),
        "ts_encode": lambda: ts_encode.ts_encode(
            TSketchConfig(d=100, rows=3, width=256),
            torch.empty(100, **meta)),
        "heavymix_scores_ts": lambda: heavymix_topk.heavymix_scores_ts_hist(
            TSketchConfig(d=100, rows=3, width=256),
            torch.empty((3, 256), **meta), torch.empty((), **meta), 100),
    }


# Every C entry point the kernel modules bind, by library.
_ENTRIES = ("sketch_encode_launch", "sketch_encode_finish_launch",
            "heavymix_scores_launch",
            "heavymix_scores_ts_launch", "sketch_decode_launch",
            "ts_encode_launch", "ts_encode_onepass_launch")


_KERNEL_MODULES = (sketch_encode, heavymix_topk, sketch_decode, ts_encode)


def test_kernel_wrappers_never_fall_back(monkeypatch):
    """A non-CPU tensor launches the kernel or raises: with the build
    missing, the wrappers raise instead of running the plain version."""
    from types import SimpleNamespace

    from repro_torch.core.count_sketch import SketchConfig

    def missing(name):
        raise RuntimeError(f"no library for {name}")

    def clear():
        for mod in _KERNEL_MODULES:
            mod._lib.cache_clear()

    calls = _wrapper_calls()
    assert set(calls) == {"sketch_encode", "heavymix_scores",
                          "sketch_decode", "ts_encode", "heavymix_scores_ts"}
    monkeypatch.setattr(build, "load", missing)
    clear()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no library"):
            call()
    # with a library at hand, a tensor that is neither CPU nor CUDA is
    # refused before any launch
    monkeypatch.setattr(build, "load", lambda name: SimpleNamespace(**{
        e: SimpleNamespace() for e in _ENTRIES}))
    clear()
    for name, call in calls.items():
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            call()
    clear()
    # CPU tensors take the plain version without touching the build
    cfg = SketchConfig(rows=3, width=256)
    out = sketch_encode.sketch_encode(cfg, torch.ones(10))
    assert out.shape == (3, 256) and float(out.abs().sum()) == 30.0


def test_kernel_target_covers_included_headers(tmp_path, monkeypatch):
    """The library's name hashes the source AND every csrc header it
    includes (recursively), so an edited header is never served by a
    stale library; an unrelated header does not change it."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define A 1\n")
    (tmp_path / "other.cuh").write_text("#define B 1\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    assert sorted(build._sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    first = build._target("k")[1]
    (tmp_path / "other.cuh").write_text("#define B 2\n")
    assert build._target("k")[1] == first
    (tmp_path / "b.cuh").write_text("#define A 2\n")
    second = build._target("k")[1]
    assert second != first and os.path.basename(second).startswith("libk-")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return 0; }\n')
    assert build._target("k")[1] not in (first, second)


def test_build_paths_stay_in_repo():
    assert build.BUILD_DIR.startswith(ROOT)
    for name in ("sketch_encode", "heavymix_scores", "sketch_decode",
                 "ts_encode"):
        assert os.path.isfile(os.path.join(build.CSRC, f"{name}.cu"))
        assert "sketch_common.cuh" in build._sources(name)
