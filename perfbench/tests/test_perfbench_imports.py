"""Nothing under perfbench/ imports JAX, the JAX package, chip_smoke or
the JAX package's benchmarks (whole top-level names: repro_torch is not
repro); the reference's side imports nothing of the program."""

import ast
import os

import pytest

from pbench import cells

BANNED = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks"}
# the modules the reference and the yardstick are made of
REFERENCE_SIDE = ["pbench/reference.py", "pbench/sketch_ref.py",
                  "pbench/layout.py", "pbench/inputs.py",
                  "pbench/observe.py", "pbench/compare.py",
                  "pbench/trace.py", "pbench/readers.py", "counts",
                  "metrics"]


def sources(rel=""):
    top = os.path.join(cells.PERFBENCH, rel)
    if top.endswith(".py"):
        return [top]
    out = []
    for d, _, files in os.walk(top):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sources(),
                         ids=lambda p: os.path.relpath(p, cells.PERFBENCH))
def test_perfbench_no_jax(path):
    assert not set(imported(path)) & BANNED


@pytest.mark.parametrize("path", [p for r in REFERENCE_SIDE
                                  for p in sources(r)],
                         ids=lambda p: os.path.relpath(p, cells.PERFBENCH))
def test_perfbench_reference_side_imports_no_program(path):
    assert "repro_torch" not in set(imported(path))
