"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no CPU mode, so these skip on a machine without
a card; on one, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the port's card
machine does not need.)

Tolerances: the encode kernel adds with f32 atomics in a run-dependent
order, so it is held to the plain version at 1e-4 * max|S|; the scores
and decode kernels gather and sort the same values as the plain version,
so their estimates and scores must be bit-equal. The TS encode kernel
adds each bucket's contributors in a fixed order (bit-reproducible run to
run) but another order than the plain ``index_add_``: 1e-4 * max|S|.
"""

import pytest
import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core import ts_sketch as ts
from repro_torch.core.heavymix import topk_lower_index
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.kernels.heavymix_topk import (heavymix_scores,
                                               heavymix_scores_plain)
from repro_torch.kernels.sketch_decode import (sketch_decode,
                                               sketch_decode_plain)
from repro_torch.kernels.sketch_encode import (sketch_encode,
                                               sketch_encode_plain)
from repro_torch.kernels.ts_encode import ts_encode, ts_encode_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,rows,width,offset", [(2000, 3, 512, 0),
                                                 (1537, 5, 256, 4099),
                                                 (1 << 20, 5, 1 << 14, 7)])
def test_encode_kernel_matches_plain(card, dtype, d, rows, width, offset):
    cfg = cs.SketchConfig(rows=rows, width=width, seed=3)
    gen = torch.Generator(device=card).manual_seed(d)
    g = torch.randn(d, generator=gen, device=card).to(dtype)
    before = LAUNCHES["sketch_encode"]
    got = sketch_encode(cfg, g, index_offset=offset)
    assert LAUNCHES["sketch_encode"] == before + 1
    want = sketch_encode_plain(cfg, g, offset)
    assert got.shape == (rows, cfg.width) and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("rows", [1, 4, 5, 16, 17, 29])
def test_scores_kernel_bit_equal(card, rows):
    d, k = 20_000, 100
    cfg = cs.SketchConfig(rows=rows, width=1024, seed=rows)
    gen = torch.Generator(device=card).manual_seed(rows)
    g = 0.01 * torch.randn(d, generator=gen, device=card)
    g[:: d // 50] = 5.0
    sk = sketch_encode_plain(cfg, g)
    thr = cs.l2sq_estimate(sk) / k
    before = LAUNCHES["heavymix_scores"]
    sc, est = heavymix_scores(cfg, sk, thr, d)
    assert LAUNCHES["heavymix_scores"] == before + 1
    sc_p, est_p = heavymix_scores_plain(cfg, sk, thr, d)
    assert torch.equal(est, est_p)
    assert torch.equal(sc, sc_p)
    assert torch.equal(topk_lower_index(sc, k)[1],
                       topk_lower_index(sc_p, k)[1])


def test_recover_on_card_matches_cpu(card):
    d, k = 50_000, 200
    cfg = cs.SketchConfig(rows=5, width=2048, seed=1)
    gen = torch.Generator().manual_seed(0)
    g = 0.01 * torch.randn(d, generator=gen)
    g[torch.randperm(d, generator=gen)[:100]] = 3.0
    sk = cs.encode(cfg, g)
    idx_c, est_c = ops.heavymix_recover(cfg, sk, k, d)
    idx_g, est_g = ops.heavymix_recover(cfg, sk.to(card), k, d)
    assert torch.equal(idx_g.cpu(), idx_c)
    assert torch.equal(est_g.cpu(), est_c)


@pytest.mark.parametrize("rows", [1, 4, 5, 16, 17, 29])
@pytest.mark.parametrize("offset,width", [(0, 1024), (4099, 300),
                                          (2**32 - 7000, 2048)])
def test_decode_kernel_bit_equal(card, rows, offset, width):
    """With an index_offset (the last wraps past 2^32, as uint32 does) and
    a width below the Pallas kernel's 512-wide block."""
    d = 20_000
    cfg = cs.SketchConfig(rows=rows, width=width, seed=rows)
    gen = torch.Generator(device=card).manual_seed(rows)
    sk = torch.randn((rows, cfg.width), generator=gen, device=card)
    before = LAUNCHES["sketch_decode"]
    est = sketch_decode(cfg, sk, d, index_offset=offset)
    assert LAUNCHES["sketch_decode"] == before + 1
    assert torch.equal(est, sketch_decode_plain(cfg, sk, d, offset))


def test_recover_chunked_regime_launches_decode(card):
    """d > 2^22 and d > 4k: the recovery takes est from the decode kernel,
    launches no scores kernel, and selects what the CPU selects."""
    d, k = (1 << 22) + 5000, 2048
    cfg = cs.SketchConfig(rows=5, width=1024, seed=9)
    gen = torch.Generator().manual_seed(9)
    g = 0.1 * torch.randn(d, generator=gen)
    g[torch.randperm(d, generator=gen)[:20]] = 10.0
    sk = cs.encode(cfg, g)
    before = dict(LAUNCHES)
    idx_g, est_g = ops.heavymix_recover(cfg, sk.to(card), k, d)
    assert LAUNCHES["sketch_decode"] == before.get("sketch_decode", 0) + 1
    assert LAUNCHES["heavymix_scores"] == before.get("heavymix_scores", 0)
    idx_c, est_c = ops.heavymix_recover(cfg, sk, k, d)
    assert torch.equal(idx_g.cpu(), idx_c)
    assert torch.equal(est_g.cpu(), est_c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,rows,width", [
    (1000, 1, 512), (100_000, 5, 512), (70_000, 5, 16), (1 << 20, 5, 1 << 14),
    (3_000_001, 3, 1 << 16)])
def test_ts_encode_kernel_matches_plain(card, dtype, d, rows, width):
    """Every geometry path: rows with n_r <= W and (at W = 16) n_r > W, d
    far below d_pad, few buckets and many contributors a thread."""
    cfg = ts.TSketchConfig(d=d, rows=rows, width=width, seed=3)
    gen = torch.Generator(device=card).manual_seed(d)
    g = torch.randn(d, generator=gen, device=card).to(dtype)
    before = LAUNCHES["ts_encode"]
    got = ts_encode(cfg, g)
    assert LAUNCHES["ts_encode"] == before + 1
    assert got.shape == (rows, cfg.width) and got.dtype == torch.float32
    assert torch.equal(got, ts_encode(cfg, g))  # fixed order, no atomics
    want = ts_encode_plain(cfg, g)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
