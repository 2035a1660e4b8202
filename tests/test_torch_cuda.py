"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no CPU mode, so these skip on a machine without
a card; on one, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the port's card
machine does not need.)

Tolerances: the encode kernel bins and adds with shared-memory atomics in
a run-dependent order, so it is held to the plain version at
1e-4 * max|S|; the scores
and decode kernels gather and sort the same values as the plain version,
so their estimates and scores must be bit-equal, and the first-digit
histograms they count on request must equal the plain histogram of the
same keys. The top-k radix select picks exact keys: indices equal as
returned and values bit-equal to its plain version and to
``topk_lower_index``. The TS encode kernels (one-pass and R-pass)
add each bucket's contributors in a fixed order (bit-reproducible run to
run) but another order than the plain ``index_add_``: 1e-4 * max|S|. The
TS-map scores kernel gathers and sorts the same values as ``ts.decode``:
est and scores bit-equal, and the TS recovery selects the plain route's
indices.
"""

import pytest
import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core import heavymix as hm
from repro_torch.core import ts_sketch as ts
from repro_torch.core.heavymix import topk_lower_index
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.kernels.heavymix_topk import (heavymix_scores,
                                               heavymix_scores_hist,
                                               heavymix_scores_plain,
                                               heavymix_scores_ts_hist,
                                               heavymix_scores_ts_plain)
from repro_torch.kernels.sketch_decode import (sketch_decode,
                                               sketch_decode_hist,
                                               sketch_decode_plain)
from repro_torch.kernels.topk_select import (radix_hist_plain, topk_select,
                                             topk_select_plain)
from repro_torch.kernels.sketch_encode import (sketch_encode,
                                               sketch_encode_plain)
from repro_torch.kernels.ts_encode import (onepass_plan, rows_plan,
                                           ts_encode, ts_encode_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,rows,width,offset", [
    (2000, 3, 512, 0), (1537, 5, 256, 4099), (1 << 20, 5, 1 << 14, 7),
    (5001, 1, 256, 2**32 - 2500),        # one tile; indices wrap past 2^32
    (20_000, 29, 1 << 12, 2**32 - 7000),  # several rows a tile
    (20_000, 64, 1 << 12, 3),             # the most rows the kernel takes
    (300_000, 5, 1 << 20, 2**32 - 5),     # 128 tiles a row
    ((1 << 25) + 4099, 5, 1 << 12, 11),   # two binning passes
    (1 << 22, 3, 512, 2**32 - 100),       # one tile, 396 CTAs add to it
    (5_000_000, 29, 1 << 20, 2**32 - 9)])  # passes cut to the scratch bound
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


@pytest.mark.parametrize("rows,width", [(1, 256), (5, 1 << 20)])
def test_encode_kernel_writes_every_bucket(card, rows, width):
    """With one accumulating CTA a tile the output is not zeroed: every
    bucket is written by its tile's CTA even where no element lands (a
    NaN-filled block handed back by the allocator must not show through).
    With several (one tile here), they add into zeros."""
    cfg = cs.SketchConfig(rows=rows, width=width, seed=1)
    junk = torch.full((rows, cfg.width), float("nan"), device=card)
    del junk
    g = torch.zeros(4096, device=card)
    g[7] = 1.5
    got = sketch_encode(cfg, g)
    assert not torch.isnan(got).any()
    assert torch.equal(got, sketch_encode_plain(cfg, g))


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


@pytest.mark.parametrize("d,rows,width", [(20_000, 5, 1024), (20_000, 17, 256),
                                          (5_000_003, 5, 1 << 14)])
def test_fused_histograms_equal_plain(card, d, rows, width):
    """The decode and scores kernels with their histogram on: outputs
    bit-equal to plain, histogram equal to the plain one of the same keys."""
    cfg = cs.SketchConfig(rows=rows, width=width, seed=rows)
    gen = torch.Generator(device=card).manual_seed(d)
    sk = torch.randn((rows, cfg.width), generator=gen, device=card)
    est, hist = sketch_decode_hist(cfg, sk, d)
    assert torch.equal(est, sketch_decode_plain(cfg, sk, d))
    assert torch.equal(hist, radix_hist_plain(est))
    thr = cs.l2sq_estimate(sk) / 1000
    sc, e, h = heavymix_scores_hist(cfg, sk, thr, d)
    sc_p, e_p = heavymix_scores_plain(cfg, sk, thr, d)
    assert torch.equal(sc, sc_p) and torch.equal(e, e_p)
    assert torch.equal(h, radix_hist_plain(sc_p))


def _keys(kind, n, card):
    gen = torch.Generator(device=card).manual_seed(n)
    if kind == "est":      # medians of sketch cells: many repeated values
        cells = torch.randn(n // 64, generator=gen, device=card)
        return cells[torch.randint(0, cells.numel(), (n,), generator=gen,
                                   device=card)]
    if kind == "equal":
        return torch.full((n,), -0.5, device=card)
    # HEAVYMIX scores with |H| >> k: half the keys tie at exactly 1e30
    s = torch.randn(n, generator=gen, device=card).abs()
    return torch.where(torch.rand(n, generator=gen, device=card) < 0.5,
                       s + 1e30, s)


@pytest.mark.parametrize("kind", ["est", "equal", "ties_1e30"])
@pytest.mark.parametrize("n,k", [(5_000_001, 20_000), (5_000_001, 1),
                                 (5_000_001, 4_999_999), (3000, 2999)])
def test_select_kernel_equals_plain(card, kind, n, k):
    """The select at d ~ 5M from the first digit's histogram: idx equal as
    returned, values bit-equal, one launch a call."""
    x = _keys(kind, n, card)
    hist = radix_hist_plain(x)
    want_v, want_i = topk_select_plain(x, k, hist)
    lo_v, lo_i = topk_lower_index(x.abs(), k)
    assert torch.equal(want_i, lo_i) and torch.equal(want_v, lo_v)
    before = LAUNCHES["topk_select"]
    v, i = topk_select(x, k, hist)
    assert LAUNCHES["topk_select"] == before + 1
    assert torch.equal(i, want_i)
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))


def test_recover_syncs_with_host_nowhere(card):
    """ops.heavymix_recover in both regimes raises nothing under
    torch.cuda.set_sync_debug_mode("error") (after a first call has put
    the hash parameters on the card) and selects what the CPU selects."""
    gen = torch.Generator().manual_seed(2)
    for d, k, width in (((1 << 22) + 5000, 2048, 1024), (60_000, 300, 512)):
        cfg = cs.SketchConfig(rows=5, width=width, seed=4)
        sk = cs.encode(cfg, torch.randn(d, generator=gen))
        sk_g = sk.to(card)
        ops.heavymix_recover(cfg, sk_g, k, d)
        torch.cuda.synchronize()
        before = LAUNCHES["topk_select"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx, est = ops.heavymix_recover(cfg, sk_g, k, d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert LAUNCHES["topk_select"] == before + 1
        idx_c, est_c = ops.heavymix_recover(cfg, sk, k, d)
        assert torch.equal(idx.cpu(), idx_c)
        assert torch.equal(est.cpu(), est_c)


@pytest.mark.parametrize("kernel", ["onepass", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,rows,width", [
    (3_000_001, 5, 1 << 16), (600_001, 3, 1 << 14), (1 << 22, 2, 1 << 14),
    (5_000_003, 6, 1 << 17), (20_000_001, 4, 1 << 17),
    (9_000_001, 5, 1 << 15)])
def test_ts_encode_each_plan(card, kernel, dtype, d, rows, width):
    """Both TS encode kernels at geometries the one-pass kernel takes
    (n_max 32..256, 2..6 rows, d far below d_pad or equal to it): within
    1e-4 * max|S| of plain and bit-equal between two launches."""
    cfg = ts.TSketchConfig(d=d, rows=rows, width=width, seed=4)
    plan = onepass_plan(cfg) if kernel == "onepass" else rows_plan(cfg)
    assert plan is not None
    gen = torch.Generator(device=card).manual_seed(d)
    g = torch.randn(d, generator=gen, device=card).to(dtype)
    got = ts_encode(cfg, g, plan)
    assert torch.equal(got, ts_encode(cfg, g, plan))
    want = ts_encode_plain(cfg, g)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_ts_encode_onepass_unaligned_g(card):
    """A g whose base is not 16-byte aligned (a slice at an odd offset):
    the one-pass kernel reads it element by element."""
    cfg = ts.TSketchConfig(d=3_000_001, rows=5, width=1 << 16, seed=2)
    gen = torch.Generator(device=card).manual_seed(2)
    g = torch.randn(3_000_002, generator=gen, device=card)[1:]
    got = ts_encode(cfg, g, onepass_plan(cfg))
    want = ts_encode_plain(cfg, g)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _ts_sketch(card, d, rows, width, seed):
    cfg = ts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
    gen = torch.Generator(device=card).manual_seed(seed)
    return cfg, torch.randn((rows, cfg.width), generator=gen, device=card)


@pytest.mark.parametrize("d,rows,width", [
    (20_000, 3, 256), (20_000, 4, 1024), (70_000, 5, 16), (5_000_003, 5,
                                                            1 << 14),
    (20_000, 17, 512)])
def test_ts_scores_kernel_bit_equal(card, d, rows, width):
    """The TS-map scores: est and scores bit-equal to ``ts.decode`` and the
    reference's boost, the histogram equal, one launch counted as
    heavymix_scores_ts."""
    cfg, sk = _ts_sketch(card, d, rows, width, rows)
    thr = cs.l2sq_estimate(sk) / 1000
    before = dict(LAUNCHES)
    sc, est, hist = heavymix_scores_ts_hist(cfg, sk, thr, d)
    assert LAUNCHES["heavymix_scores_ts"] == before.get(
        "heavymix_scores_ts", 0) + 1
    assert LAUNCHES["heavymix_scores"] == before.get("heavymix_scores", 0)
    sc_p, est_p = heavymix_scores_ts_plain(cfg, sk, thr, d)
    assert torch.equal(est, est_p) and torch.equal(sc, sc_p)
    assert torch.equal(hist, radix_hist_plain(sc_p))


def test_ts_recover_matches_plain_route(card):
    """At d ~ 5M, heavy set >> k: ops.ts_heavymix_recover selects what
    ts.decode + heavymix(estimates=) selects, on the card and on the CPU."""
    d, k = 5_000_003, 20_000
    cfg, sk = _ts_sketch(card, d, 5, 1 << 14, 8)
    ccfg = cs.SketchConfig(rows=5, width=1 << 14, seed=8)
    idx, est = ops.ts_heavymix_recover(cfg, sk, k, d)
    want = hm.heavymix(ccfg, sk, k, d, estimates=ts.decode(cfg, sk, d))
    assert torch.equal(idx, want[0]) and torch.equal(est, want[1])
    idx_c, est_c = ops.ts_heavymix_recover(cfg, sk.cpu(), k, d)
    assert torch.equal(idx.cpu(), idx_c) and torch.equal(est.cpu(), est_c)


def test_ts_recover_syncs_with_host_nowhere(card):
    d, k = 5_000_003, 20_000
    cfg, sk = _ts_sketch(card, d, 5, 1 << 14, 9)
    ops.ts_heavymix_recover(cfg, sk, k, d)
    torch.cuda.synchronize()
    before = LAUNCHES["topk_select"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, _ = ops.ts_heavymix_recover(cfg, sk, k, d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert LAUNCHES["topk_select"] == before + 1
    assert torch.equal(idx, ops.ts_heavymix_recover(cfg, sk, k, d)[0])
