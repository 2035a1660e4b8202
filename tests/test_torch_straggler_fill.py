"""Port parity: a straggler drop through the whole train step against
the JAX package (tests/test_torch_straggler_step.py's check), with
microbatch accumulation and with HEAVYMIX's faithful fill."""

import pytest

from tests.test_torch_straggler_step import check_variant


@pytest.mark.parametrize("name", ["microbatch-psum", "faithful-tree"])
def test_masked_step_equals_the_reference(name, monkeypatch):
    check_variant(name, monkeypatch)
