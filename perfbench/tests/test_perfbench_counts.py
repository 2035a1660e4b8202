"""The FLOP and byte counts on shapes worked by hand."""

import pytest

from counts import model_flops, peaks, sketch_work
from pbench import layout


def shape(**kw):
    base = dict(hidden_size=8, num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=1, intermediate_size=16, vocab_size=10,
                tie_word_embeddings=False, rms_norm_eps=1e-5,
                rope_theta=1e4)
    base.update(kw)
    return layout.Shape.of(base)


def test_perfbench_matmul_params():
    # per layer: wq 8x8 + wo 8x8 = 128; wk, wv 8x4 each = 64; 3 x 8x16 =
    # 384 -> 576; two layers 1152; head 8 x 10 = 80
    assert model_flops.matmul_params(shape()) == 1152 + 80


def test_perfbench_train_flops():
    # 6 * 1232 * 3 tokens, plus 6 * S^2 * H * hd * L * seqs = 6*9*2*4*2*1
    assert model_flops.train_flops(shape(), 1, 3) == 6 * 1232 * 3 + 864


@pytest.mark.parametrize("rows,comparisons", [(3, 3), (5, 6), (7, 10)])
def test_perfbench_sketch_work(rows, comparisons):
    d, w, k = 1000, 64, 7
    ops, nbytes = sketch_work.encode(d, rows, w)
    assert ops == d + 2 * rows * d
    assert nbytes == 12 * d + 4 * rows * w
    ops, nbytes = sketch_work.recover(d, rows, w, k)
    assert ops == d * (rows + comparisons + 1)
    assert nbytes == 4 * rows * w + 16 * k


def test_perfbench_least_seconds_takes_the_binding_bound():
    assert sketch_work.least_seconds(67e12, 0, 67e12, 3.35e12) == 1.0
    assert sketch_work.least_seconds(0, 3.35e12, 67e12, 3.35e12) == 1.0
    assert peaks.FLOPS["float32"] == 67e12
