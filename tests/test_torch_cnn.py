"""Port parity: the paper's CNNs (``repro_torch.models.cnn``) and
``count_sketch.ravel_tree`` against ``repro/models/cnn.py`` and
``repro/core/count_sketch.py``, on the CPU, from the reference's
parameters (carried across with ``cnn.params_from_reference``).

Tolerances: logits, losses and the group norm at rtol 1e-5 / atol 2e-5
(f32 convolutions and reductions in another order; logits reach ~7); the
convolutions alone at atol 1e-5; pooling, accuracy and the raveled
vector exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro.models import cnn as jcnn
from repro_torch.core import count_sketch as tcs
from repro_torch.models import cnn as tcnn

SMALL = {"resnet20": {"width": 8}, "vgg16": {"width_mult": 0.25}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, as the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_params(model, **kw):
    init, _ = jcnn.MODELS[model]
    return init(jax.random.PRNGKey(0), **(kw or SMALL[model]))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [16, 32])
@pytest.mark.parametrize("k, stride", [(3, 1), (3, 2), (1, 2), (1, 1)])
def test_conv_same_padding(hw, k, stride):
    """XLA's SAME: a 3x3 stride-2 conv on an even map pads 0 before and 1
    after; the 1x1 stride-2 proj pads nothing."""
    rs = np.random.RandomState(hw + k + stride)
    x = rs.randn(2, hw, hw, 5).astype(np.float32)
    w = rs.randn(k, k, 5, 7).astype(np.float32)
    want = np.asarray(jcnn._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tcnn._conv(nchw(x), torch.tensor(w), stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if k == 3 and stride == 2:   # torch's symmetric padding reads elsewhere
        off = torch.nn.functional.conv2d(
            nchw(x), torch.tensor(w).permute(3, 2, 0, 1), stride=2,
            padding=1).permute(0, 2, 3, 1)
        assert np.abs(off.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("c", [4, 8, 16, 64])
def test_groupnorm(c):
    rs = np.random.RandomState(c)
    x = (3.0 + 2.0 * rs.randn(2, 8, 8, c)).astype(np.float32)
    s, b = (0.1 * rs.randn(c)).astype(np.float32), rs.randn(c).astype(
        np.float32)
    want = np.asarray(jcnn._groupnorm(jnp.asarray(x), jnp.asarray(s),
                                      jnp.asarray(b)))
    got = tcnn._groupnorm(nchw(x), torch.tensor(s), torch.tensor(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=2e-5)


def test_max_pool_as_reduce_window():
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1),
        "VALID"))
    got = torch.nn.functional.max_pool2d(nchw(x), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model", sorted(SMALL))
def test_forward_parity(model):
    p = ref_params(model)
    x = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)
    want = np.asarray(jcnn.MODELS[model][1](p, jnp.asarray(x)))
    got = tcnn.MODELS[model][1](tcnn.params_from_reference(to_np(p)),
                                torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=2e-5)


def test_resnet20_full_width_forward_parity():
    """The full-size ResNet-20 (width 16: the stride-2 blocks at 32 -> 16
    and 16 -> 8 with 16 and 32 channels)."""
    p = ref_params("resnet20", width=16)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jcnn.resnet20_logits(p, jnp.asarray(x)))
    got = tcnn.resnet20_logits(tcnn.params_from_reference(to_np(p)),
                               torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=2e-5)


def test_loss_and_accuracy():
    rs = np.random.RandomState(3)
    logits = (4 * rs.randn(16, 10)).astype(np.float32)
    logits[3, 2] = logits[3, 7] = 50.0         # a tie: the first max wins
    labels = rs.randint(0, 10, 16).astype(np.int32)
    labels[3] = 2
    jl, ja = jnp.asarray(logits), jnp.asarray(labels)
    tl, ta = torch.tensor(logits), torch.tensor(labels.astype(np.int64))
    np.testing.assert_allclose(float(tcnn.ce_loss(tl, ta)),
                               float(jcnn.ce_loss(jl, ja)), rtol=1e-6)
    assert float(tcnn.accuracy(tl, ta)) == float(jcnn.accuracy(jl, ja))
    p = ref_params("resnet20")
    x = np.random.RandomState(4).randn(4, 32, 32, 3).astype(np.float32)
    y = np.array([0, 1, 2, 3])
    wl, wa = jcnn.loss_and_acc(jcnn.resnet20_logits, p, jnp.asarray(x),
                               jnp.asarray(y))
    gl, ga = tcnn.loss_and_acc(tcnn.resnet20_logits,
                               tcnn.params_from_reference(to_np(p)),
                               torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    assert float(ga) == float(wa)


@pytest.mark.parametrize("model", sorted(SMALL))
def test_ravel_order_and_round_trip(model):
    p = ref_params(model)
    tp = tcnn.params_from_reference(to_np(p))
    want, _ = jcs.ravel_tree(p)
    got, info = tcs.ravel_tree(tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [tuple(x.shape) for x in tcs.tree_leaves(tp)] == [
        x.shape for x in jax.tree_util.tree_leaves(p)]
    back = tcs.unravel_tree(got, info)
    assert list(back) == list(tp)
    for a, b in zip(tcs.tree_leaves(back), tcs.tree_leaves(tp)):
        assert torch.equal(a, b)
    if model == "resnet20":   # 61 leaves, fc first and stem last
        names = [(k, j) for k in sorted(tp) for j in sorted(tp[k])]
        assert len(names) == 61
        assert names[:5] == [("fc", "b"), ("fc", "w"), ("s0b0", "b1"),
                             ("s0b0", "b2"), ("s0b0", "s1")]
        assert names[-3:] == [("stem", "b"), ("stem", "s"), ("stem", "w")]


def test_ravel_nested_sequences_and_dtypes():
    tree = {"b": [torch.ones(2), (torch.zeros(1, 3, dtype=torch.float16),)],
            "a": torch.arange(3.0)}
    flat, info = tcs.ravel_tree(tree)
    assert flat.tolist() == [0.0, 1.0, 2.0, 1.0, 1.0, 0.0, 0.0, 0.0]
    back = tcs.unravel_tree(flat, info)
    assert back["b"][1][0].dtype == torch.float16
    assert isinstance(back["b"], list) and isinstance(back["b"][1], tuple)


@pytest.mark.parametrize("model, d", [("resnet20", 272_282),
                                      ("vgg16", 14_724_042)])
def test_init_shapes_and_scale(model, d):
    """The port's init: the reference's shapes and He scale (another
    draw: torch cannot redraw jax.random)."""
    init, _ = tcnn.MODELS[model]
    tp = init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jcnn.MODELS[model][0](
        jax.random.PRNGKey(0)))
    assert [tuple(x.shape) for x in tcs.tree_leaves(tp)] == [
        x.shape for x in jax.tree_util.tree_leaves(want)]
    assert sum(x.numel() for x in tcs.tree_leaves(tp)) == d
    w = tp["fc"]["w"]
    assert abs(float(w.std()) - (2.0 / w.shape[0]) ** 0.5) < 0.1 * (
        2.0 / w.shape[0]) ** 0.5


def test_weight_carry():
    p = to_np(ref_params("vgg16"))
    tp = tcnn.params_from_reference(p)
    for (ka, a), (kb, b) in zip(sorted(p.items()), sorted(tp.items())):
        for j in a:
            assert b[j].dtype == torch.float32
            np.testing.assert_array_equal(b[j].numpy(), a[j])
