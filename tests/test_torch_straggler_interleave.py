"""Port parity: a straggler drop through the whole train step against
the JAX package (tests/test_torch_straggler_step.py's check), on the
backward-interleaved exchange with and without the fused encode."""

import pytest

from tests.test_torch_straggler_step import check_variant


@pytest.mark.parametrize("name", ["interleaved-fused-psum",
                                  "interleaved-tree"])
def test_masked_step_equals_the_reference(name, monkeypatch):
    check_variant(name, monkeypatch)
