"""Port parity: repro_torch.core.allreduce against repro.core.allreduce.

The schedules are pure python/numpy and must be equal; the tree
all-reduce over the leading worker axis must equal the sum (and the
reference's vmap'd tree) exactly for these integer-valued inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allreduce as jar
from repro_torch.core import allreduce as tar


@pytest.mark.parametrize("p", list(range(1, 12)))
def test_schedules_equal(p):
    assert tar.reduce_schedule(p) == jar.reduce_schedule(p)
    for (ts, td), (js, jd) in zip(tar.reduce_schedule_arrays(p),
                                  jar.reduce_schedule_arrays(p)):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(td, jd)
    assert tar.tree_allreduce_rounds(p) == jar.tree_allreduce_rounds(p)


@pytest.mark.parametrize("p", range(2, 10))
def test_tree_equals_psum_and_reference(p):
    """Odd, even-non-power-of-two and power-of-two P (paper Fig. 1a-c)."""
    x = np.random.RandomState(p).randint(-50, 50, (p, 3, 8)).astype(
        np.float32)
    tree = tar.tree_allreduce(torch.from_numpy(x), p)
    np.testing.assert_array_equal(tree.numpy(),
                                  np.broadcast_to(x.sum(0), x.shape))
    np.testing.assert_array_equal(
        tar.allreduce(torch.from_numpy(x), p, mode="psum").numpy(),
        tree.numpy())
    want = jax.vmap(lambda v: jar.tree_allreduce(v, "data", p),
                    axis_name="data")(jnp.asarray(x))
    np.testing.assert_array_equal(tree.numpy(), np.asarray(want))


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        tar.allreduce(torch.zeros(2, 3), 2, mode="ring")
