"""Port parity: every method of the convergence driver but gs-SGD
(``benchmarks/convergence.METHODS``) through the paper's experiment step
(``bench/cnn_dist.run`` against ``benchmarks/cnn_dist.run``): two steps at
ResNet-20 ``width=8``, P = 4, k = 2,048, R = 5, W = 8,192, from the
reference's parameters and batches. Losses at rtol 1e-4 (the first at
1e-5: the same forward in another conv order; see
tests/test_torch_cnn_dist.py for the f32 gradient noise behind the
second), accuracies equal, the step's CommStats equal.
"""

import numpy as np
import pytest
import torch

from benchmarks import cnn_dist as jcd
from benchmarks import convergence as jconv
from tests.test_torch_cnn_dist import (GB, K, P, ROWS, WIDTH, WIDTHS,
                                       port_run, ref_batches)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, as the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OTHERS = [m for m in jconv.METHODS if m != "gs-sgd"]


@pytest.mark.parametrize("method", OTHERS)
def test_other_methods_two_steps(method):
    """Every other method of the convergence driver, two steps at
    ResNet-20 width 8 from the reference's params and batches: losses at
    rtol 1e-4 (the first at 1e-5), accuracies equal."""
    steps, model = 2, "resnet20"
    want = jcd.run(model, method, P=P, steps=steps, global_batch=GB, k=K,
                   rows=ROWS, width=WIDTH, width_kw=WIDTHS[model])
    losses, accs, d, stats = port_run(model, method, steps,
                                      ref_batches(steps))
    assert d == want.d
    assert losses[0] == pytest.approx(want.losses[0], rel=1e-5)
    np.testing.assert_allclose(losses, want.losses, rtol=1e-4)
    assert accs == want.accs
    assert stats.bytes_out == pytest.approx(want.stats.bytes_out)
    assert stats.rounds == want.stats.rounds
