"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. A CUDA kernel has no CPU mode, so these skip on a machine without
a card; on one, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the port's card
machine does not need.)

Tolerances: the encode kernel sums exactly (integer limbs), so it is
bit-equal to its plain version for any launch geometry and any cutting
into fragments (the ``test_exact_encode_*`` tests; the older tests' bound
of 1e-4 * max|S| holds a fortiori); the scores
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
                                               heavymix_scores_ts_plain,
                                               ts_transpose,
                                               ts_transpose_plain)
from repro_torch.kernels.sketch_decode import (sketch_decode,
                                               sketch_decode_hist,
                                               sketch_decode_plain)
from repro_torch.kernels.topk_select import (radix_hist_plain, select_plan,
                                             slab_overflows, topk_select,
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


def test_partial_encodes_sum_to_the_whole(card):
    """The fused encode's launches: each fragment encoded at its offset in
    the bucket (one of them short, as top_r's 2,560), each within
    1e-4 * max|S| of plain at that offset (the exact partials converted
    by ``ops.encode_finish``); ``stage_encode_merge`` of the (P, n)
    partials within the same bound of the whole-bucket encode."""
    from repro_torch.core import compression as comp
    c = comp.make("gs-sgd", k=4000, rows=5, width=1 << 14, seed=6)
    gen = torch.Generator(device=card).manual_seed(6)
    acc = 0.01 * torch.randn((2, 2_000_000), generator=gen, device=card)
    g = torch.randn((2, 2_000_000), generator=gen, device=card)
    cuts = (0, 1_300_000, 1_302_560, 2_000_000)
    pieces = []
    before = LAUNCHES["sketch_encode"]
    for a, b in zip(cuts, cuts[1:]):
        u, sk = c.stage_encode_partial(acc[:, a:b], g[:, a:b], a)
        fin = ops.encode_finish(sk)
        for p in range(2):
            want = sketch_encode_plain(c.sketch, u[p], a)
            err = float((fin[p] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (a, err)
        pieces.append((a, u, sk))
    assert LAUNCHES["sketch_encode"] == before + 2 * 3
    u_m, sk_m = c.stage_encode_merge(pieces)
    u_w, sk_w = c.stage_encode(acc, g)
    assert torch.equal(u_m, u_w)
    for p in range(2):
        want = sketch_encode_plain(c.sketch, u_w[p])
        lim = 1e-4 * float(want.abs().max())
        assert float((sk_m[p] - want).abs().max()) <= lim
        assert float((sk_m[p] - sk_w[p]).abs().max()) <= 2 * lim


def _nan_sketch(card, rows, width, seed):
    """(rows, width) N(0, 1) cells with NaN planted in rows 0 and 2 (one of
    them -NaN), so a share of the coordinates meets a NaN in some row."""
    gen = torch.Generator(device=card).manual_seed(seed)
    sk = torch.randn((rows, width), generator=gen, device=card)
    cols = torch.randint(0, width, (2, 12), generator=gen, device=card)
    sk[0, cols[0]] = float("nan")
    sk[2, cols[1]] = float("nan")
    sk[2, cols[1, 0]] = -float("nan")
    return sk


@pytest.mark.parametrize("kind", ["decode", "scores", "scores_ts"])
@pytest.mark.parametrize("rows", [4, 5])
def test_nan_estimates_bit_equal_plain(card, kind, rows):
    """A NaN among a coordinate's R values makes its estimate NaN (as
    jnp.median): the decode, scores and TS-map scores kernels give plain's
    bits, NaN at the same coordinates, and the histogram of the same keys;
    the select of those keys ranks NaN first, as topk_lower_index (and
    jax.lax.top_k) does."""
    d, width, k = 300_000, 1 << 12, 2_000
    if kind == "scores_ts":
        cfg = ts.TSketchConfig(d=d, rows=rows, width=width, seed=rows)
    else:
        cfg = cs.SketchConfig(rows=rows, width=width, seed=rows)
    sk = _nan_sketch(card, rows, cfg.width, rows)
    thr = cs.l2sq_estimate(sk) / k
    assert torch.isnan(thr).all()   # row norms hold the NaN too
    if kind == "decode":
        key, hist = sketch_decode_hist(cfg, sk, d)
        want = sketch_decode_plain(cfg, sk, d)
        pairs = [(key, want)]
    elif kind == "scores":
        key, est, hist = heavymix_scores_hist(cfg, sk, thr, d)
        want, est_p = heavymix_scores_plain(cfg, sk, thr, d)
        pairs = [(key, want), (est, est_p)]
    else:
        key, est, hist = heavymix_scores_ts_hist(cfg, sk, thr, d)
        want, est_p = heavymix_scores_ts_plain(cfg, sk, thr, d)
        pairs = [(key, want), (est, est_p)]
    for got, ref in pairs:
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    n_nan = int(torch.isnan(want).sum())
    assert 0 < n_nan < d
    assert torch.equal(hist, radix_hist_plain(want))
    for kk in (k, n_nan, n_nan + 7):
        v, i = topk_select(key, kk, hist)
        lo_v, lo_i = topk_lower_index(want.abs(), kk)
        assert torch.equal(i, lo_i)
        # the select returns |x|'s own bits; torch.abs on the card writes
        # NaN as 0x7FFFFFFF: NaN at the same places, the rest bit-equal
        nan = torch.isnan(v)
        assert torch.equal(nan, torch.isnan(lo_v))
        assert torch.equal(v[~nan].view(torch.int32),
                           lo_v[~nan].view(torch.int32))
        assert bool(nan[:min(kk, n_nan)].all())


@pytest.mark.parametrize("d,rows,width", [
    (388_956_160, 5, 1 << 20), (201_864_704, 5, 1 << 19),
    (388_956_160, 5, 1 << 14), (91_648, 3, 512), (3_000_001, 5, 16),
    (20_000, 17, 512), (2 ** 32 - 5, 5, 1 << 12)])
def test_ts_transpose_kernel_equals_plain(card, d, rows, width):
    """The row-transposed TS sketch the TS-map scores kernel reads: equal
    to the plain transpose at the main cell's widths (n_r 1..256 < W), at
    16,384 (n_r = W), at small W (n_r > W) and at d_pad = 2^32; one launch
    counted as ts_transpose."""
    cfg, sk = _ts_sketch(card, d, rows, width, rows)
    before = LAUNCHES["ts_transpose"]
    got = ts_transpose(cfg, sk)
    assert LAUNCHES["ts_transpose"] == before + 1
    assert torch.equal(got, ts_transpose_plain(cfg, sk))


@pytest.mark.parametrize("d,width", [(388_956_160, 1 << 20),
                                     (201_864_704, 1 << 19),
                                     (388_956_160, 1 << 14)])
def test_ts_scores_kernel_bit_equal_at_cell_widths(card, d, width):
    """The TS-map scores at the main cell's buckets (R = 5) and at 16,384:
    est and scores bit-equal to plain, histogram equal; the transpose and
    the scores kernel launch once each."""
    cfg, sk = _ts_sketch(card, d, 5, width, 6)
    thr = cs.l2sq_estimate(sk) / 800_000
    before = dict(LAUNCHES)
    sc, est, hist = heavymix_scores_ts_hist(cfg, sk, thr, d)
    for name in ("ts_transpose", "heavymix_scores_ts"):
        assert LAUNCHES[name] == before.get(name, 0) + 1
    sc_p, est_p = heavymix_scores_ts_plain(cfg, sk, thr, d)
    assert torch.equal(est, est_p) and torch.equal(sc, sc_p)
    assert torch.equal(hist, radix_hist_plain(sc_p))


def _ties_dense_then_sparse(card, n, dense_until, seed):
    """TS-route scores: heavy keys exactly 1e30, 90% of the keys below
    ``dense_until`` and 2% above it, the rest small."""
    gen = torch.Generator(device=card).manual_seed(seed)
    s = torch.rand(n, generator=gen, device=card).mul_(1e-3)
    share = torch.full((n,), 0.02, device=card)
    share[:dense_until] = 0.9
    heavy = torch.rand(n, generator=gen, device=card) < share
    return torch.where(heavy, s + 1e30, s)


@pytest.mark.parametrize("capacity,overflow", [
    (None, "some"), (0, "all"), (32, "all"), (None, "none"), (None, "off")])
@pytest.mark.parametrize("k", [1, 20_000, 150_000])
def test_select_forced_slab_overflow(card, capacity, overflow, k):
    """The select with slabs that overflow in every CTA, in some, or in
    none (the same keys with 2% heavy everywhere), and with 90% heavy
    everywhere, more keys in the bin than all the slabs hold, so they are
    off: idx equal to topk_lower_index's as returned, values bit-equal;
    the device counter counts the CTAs that read their keys in x."""
    n = 5_000_001
    dense = {"none": 0, "off": n}.get(overflow, 1_000_000)
    x = _ties_dense_then_sparse(card, n, dense, k)
    hist = radix_hist_plain(x)
    slab_overflows(card, reset=True)
    v, i = topk_select(x, k, hist, capacity=capacity)
    lo_v, lo_i = topk_lower_index(x.abs(), k)
    assert torch.equal(i, lo_i)
    assert torch.equal(v.view(torch.int32), lo_v.view(torch.int32))
    grid = select_plan(n, torch.cuda.get_device_properties(
        card).multi_processor_count)[0]
    got = slab_overflows(card, reset=True)
    if overflow in ("all", "off"):
        assert got == grid
    elif overflow == "none":
        assert got == 0
    else:
        assert 0 < got < grid


@pytest.mark.parametrize("capacity", [None, 0])
def test_select_nan_keys_with_and_without_slabs(card, capacity):
    """NaN keys (the top digit-1 bin) through the slabs and through the
    overflow path: topk_lower_index's order, NaN first by index."""
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(5_000_001, generator=gen, device=card)
    at = torch.randint(0, x.numel(), (40,), generator=gen, device=card)
    x[at] = float("nan")
    x[at[0]] = -float("nan")
    hist = radix_hist_plain(x)
    n_nan = int(torch.isnan(x).sum())
    for k in (1, n_nan, n_nan + 1000):
        v, i = topk_select(x, k, hist, capacity=capacity)
        lo_v, lo_i = topk_lower_index(x.abs(), k)
        assert torch.equal(i, lo_i)
        nan = torch.isnan(v)
        assert torch.equal(nan, torch.isnan(lo_v))
        assert torch.equal(v[~nan].view(torch.int32),
                           lo_v[~nan].view(torch.int32))


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("d,rows,width,offset", [
    (1537, 3, 300, 4099), (20_000, 1, 1, 0), (20_000, 64, 1 << 12, 3),
    (1 << 22, 3, 512, 2**32 - 100), ((1 << 25) + 4099, 5, 1 << 12, 11),
    (20_000_000, 5, 1 << 19, 7)])
def test_exact_encode_bit_equal_across_geometry(card, d, rows, width,
                                                offset):
    """Kernel against plain, a second launch, another splits and pass
    size, and offset fragments summed in another order: all bit-equal."""
    from repro_torch.kernels import sketch_encode as ske
    cfg = cs.SketchConfig(rows=rows, width=width, seed=rows)
    gen = torch.Generator(device=card).manual_seed(d % 97)
    g = torch.randn(d, generator=gen, device=card)
    g *= torch.exp(-20 * torch.rand(d, generator=gen, device=card))
    got = sketch_encode(cfg, g, index_offset=offset)
    assert _bits_equal(got, sketch_encode_plain(cfg, g, offset))
    assert _bits_equal(got, sketch_encode(cfg, g, index_offset=offset))
    base = ske.encode_plan(rows, cfg.log2_width, d)
    other = ske.encode_plan(rows, cfg.log2_width, d,
                            splits=max(1, base.splits // 2 + 3),
                            chunk=max(base.block, (base.chunk // 3)
                                      // base.block * base.block))
    assert _bits_equal(got, sketch_encode(cfg, g, index_offset=offset,
                                          plan=other))
    cuts = sorted({0, d // 3, min(d, d // 3 + 2560), d - 5, d})
    parts = []
    for lo, hi in zip(cuts, cuts[1:]):
        acc = cs.exact_zeros(cfg, device=card)
        ske.sketch_encode_into(cfg, g[lo:hi], acc, index_offset=offset + lo)
        parts.append(acc)
    total = parts[-1]
    for acc in parts[-2::-1]:  # summed in reverse order
        total = total + acc
    assert _bits_equal(got, ske.sketch_encode_finish(total))


def test_exact_encode_nonfinite_cells(card):
    """NaN, +-inf and out-of-range elements planted at known coordinates:
    the kernel's sketch equals the plain version's bit for bit, with NaN
    and inf cells where the plain rules put them."""
    cfg = cs.SketchConfig(rows=5, width=1024, seed=3)
    gen = torch.Generator(device=card).manual_seed(8)
    g = 1e-3 * torch.randn(100_000, generator=gen, device=card)
    g[10], g[20], g[30], g[40], g[50] = (float("nan"), float("inf"),
                                         -float("inf"), 3e9, -2.0**31)
    got = sketch_encode(cfg, g)
    want = sketch_encode_plain(cfg, g)
    assert _bits_equal(got, want)
    assert int(torch.isnan(got).sum()) >= 5 and bool(torch.isinf(got).any())


@pytest.mark.parametrize("d,width", [(100_000, 1024), (5_000_003, 1 << 16)])
def test_filler_scores_bit_equal_plain(card, d, width):
    """The scores kernel with the faithful fill's filler operand, both
    bucket maps: scores and est bit-equal to plain, the histogram equal
    to the plain histogram of the scores; the recovery selects what the
    plain HEAVYMIX selects."""
    cfg = cs.SketchConfig(rows=5, width=width, seed=2)
    gen = torch.Generator(device=card).manual_seed(4)
    g = torch.randn(d, generator=gen, device=card)
    sk = sketch_encode(cfg, g)
    k = d // 100
    thr = cs.l2sq_estimate(sk) / k
    fill = hm.draw_filler(d, card)
    s, e, h = heavymix_scores_hist(cfg, sk, thr, d, fill)
    s0, e0 = heavymix_scores_plain(cfg, sk, thr, d, fill)
    assert _bits_equal(s, s0) and _bits_equal(e, e0)
    assert torch.equal(h, radix_hist_plain(s0).to(h.dtype))
    idx, _ = ops.heavymix_recover(cfg, sk, k, d, filler=fill)
    want, _ = hm.heavymix(cfg, sk, k, d, faithful=True, filler=fill)
    assert torch.equal(idx, want)
    tcfg = ts.TSketchConfig(d=d, rows=5, width=width, seed=2)
    tsk = ts.encode(tcfg, g)
    s, e, h = heavymix_scores_ts_hist(tcfg, tsk, thr, d, fill)
    s0, e0 = heavymix_scores_ts_plain(tcfg, tsk, thr, d, fill)
    assert _bits_equal(s, s0) and _bits_equal(e, e0)
    assert torch.equal(h, radix_hist_plain(s0).to(h.dtype))


def test_span_lasts_at_least_its_kernels_event_time(card):
    """An active span ends in ``sp.sync``, so on the card its host-clock
    duration covers the kernels launched inside it: at least their
    CUDA-event time. The NULL tracer's span does not wait on the card."""
    from repro_torch import obs
    from repro_torch.obs import trace as obtrace
    cfg = cs.SketchConfig(rows=5, width=1 << 20, seed=3)
    g = torch.randn(50_000_000, generator=torch.Generator(device=card)
                    .manual_seed(0), device=card)
    sketch_encode(cfg, g)              # build, load, warm
    torch.cuda.synchronize()
    tr = obs.Tracer()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with tr.activate():
        with obtrace.current().span("encode/b0", cat="encode") as sp:
            a.record()
            sk = sketch_encode(cfg, g)
            b.record()
            assert sp.sync(sk) is sk
    event_s = a.elapsed_time(b) / 1e3
    span_s = obtrace.spans(tr.to_chrome(), cat="encode")[0]["dur"]
    assert event_s > 0 and span_s >= event_s
    torch.cuda.synchronize()
    with obtrace.NULL.span("encode/b0", cat="encode") as sp:
        assert sp.sync(sk) is sk


FAMILY_RUNS = [("granite-moe-3b-a800m", {}), ("qwen3-moe-235b-a22b", {}),
               ("qwen3-moe-235b-a22b", {"optimizer": "sgdm",
                                        "ef_bf16": True}),
               ("rwkv6-7b", {}), ("zamba2-2.7b", {}),
               ("llama-3.2-vision-11b", {}),
               ("llama-3.2-vision-11b", {"cross_kv": True}),
               ("musicgen-large", {})]


@pytest.mark.parametrize("arch,kw", FAMILY_RUNS,
                         ids=[a + "".join(f"-{k}" for k in kw)
                              for a, kw in FAMILY_RUNS])
def test_family_smoke_steps_card_match_cpu(card, arch, kw):
    """Two steps of each other family's smoke config (the smoke spec with
    the arch replaced) on the card and on the CPU from the same params and
    batches: losses within 1e-3 (f32 matmuls and sums in another order,
    then the optimizer), the selected coordinates (the EF zero pattern)
    equal every step, the EF's dtype kept, and the kernels of the scores
    route launched on the card. The vlm also with seeded ``cross_kv``
    patch embeddings; qwen3-moe also under its override row's SGD with
    momentum and bf16 EF, passed in."""
    import dataclasses
    import os

    import numpy as np

    from repro_torch.api import RunSpec
    from repro_torch.core.gs_sgd import make_state
    from repro_torch.data import LMStream
    from repro_torch.launch import train as ttrain
    from repro_torch.models.flatten import init_flat_params
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "specs", "qwen3_smoke.json")
    spec = dataclasses.replace(RunSpec.load(path), arch=arch,
                               optimizer=kw.get("optimizer"))
    ef_dtype = torch.bfloat16 if kw.get("ef_bf16") else torch.float32
    runs = []
    for dev in (torch.device("cpu"), card):
        cfg, opt, _, ts = ttrain.build(spec, dev)
        params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1,
                                  ts.fs)
        st = make_state({k: v.to(dev) for k, v in params.items()}, opt,
                        ts.compressor, ts.d_local, ts.nworkers,
                        ef_dtype=ef_dtype)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                          global_batch=spec.batch, seed=spec.seed)
        LAUNCHES.clear()
        losses, sel = [], []
        for step in range(2):
            gb = stream.global_batch_at(step, dev)
            if kw.get("cross_kv"):
                rs = np.random.RandomState(step)
                gb["cross_kv"] = torch.from_numpy(rs.randn(
                    spec.batch, cfg.n_cross_tokens, cfg.d_model).astype(
                        np.float32)).to(dev)
            st, m = ts.fn(st, ttrain.shard_batch(gb, ts.nworkers))
            losses.append(float(m["loss"]))
            sel.append([(e == 0).cpu() for e in st["ef"]])
        runs.append((losses, sel, [e.dtype for e in st["ef"]],
                     dict(LAUNCHES)))
    (lc, sc, dc, _), (lg, sg, dg, counts) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    for a, b in zip(sc, sg):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert dc == dg == [ef_dtype] * len(dc)
    for name in ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                 "topk_select"):
        assert counts.get(name, 0) > 0, name


@pytest.mark.parametrize("d,width", [
    (272_282, 1024),        # ResNet-20 full size: R*W = 5,120 < one tile
    (68_690, 256),          # ResNet-20 width 8 at paper_geometry
    (923_130, 8192),        # VGG-16 width 0.25 at the figures' W
    (923_130, 256),         # W = 256 at an odd d
    (14_724_042, 32_768)])  # VGG-16 full size: the decode route
def test_paper_cells_encode_and_recover_bit_equal(card, d, width):
    """The paper's CNN cells' shapes: the exact encode (one tile and
    less) bit-equal to plain and to a second launch; the recovery's
    kernel (decode or scores, as the cell's d and k route it) and the
    select equal to plain."""
    from repro_torch.bench.time_breakdown import paper_geometry
    from repro_torch.core.heavymix import _CHUNK
    k = paper_geometry(d)[0]
    cfg = cs.SketchConfig(rows=5, width=width, seed=0)
    gen = torch.Generator(device=card).manual_seed(d % 101)
    g = torch.randn(d, generator=gen, device=card)
    g *= torch.exp(-20 * torch.rand(d, generator=gen, device=card))
    sk = sketch_encode(cfg, g)
    assert _bits_equal(sk, sketch_encode_plain(cfg, g))
    assert _bits_equal(sk, sketch_encode(cfg, g))
    if d > _CHUNK and d > 4 * k:
        key, hist = sketch_decode_hist(cfg, sk, d)
        assert torch.equal(key, sketch_decode_plain(cfg, sk, d))
    else:
        thr = cs.l2sq_estimate(sk) / k
        key, est, hist = heavymix_scores_hist(cfg, sk, thr, d)
        s_p, e_p = heavymix_scores_plain(cfg, sk, thr, d)
        assert torch.equal(key, s_p) and torch.equal(est, e_p)
    assert torch.equal(hist, radix_hist_plain(key))
    v, i = topk_select(key, k, hist)
    v_p, i_p = topk_select_plain(key, k, hist)
    assert torch.equal(i, i_p) and _bits_equal(v, v_p)


def test_cnn_step_same_bits_twice(card):
    """Two runs of three ResNet-20 (full size) gs-SGD steps on the card,
    cuDNN deterministic (``cnn_dist.prepare_device``): the same losses,
    bit for bit; the scores route's kernel once a worker and step."""
    from repro_torch.bench import cnn_dist
    from repro_torch.bench.time_breakdown import paper_geometry
    k, width = paper_geometry(272_282)
    runs = []
    for _ in range(2):
        LAUNCHES.clear()
        r = cnn_dist.run("resnet20", "gs-sgd", P=4, steps=3, k=k, rows=5,
                         width=width, device=card)
        assert LAUNCHES["heavymix_scores"] == 12
        assert LAUNCHES["sketch_decode"] == 0
        runs.append(r.losses)
    assert runs[0] == runs[1]
    assert torch.backends.cudnn.deterministic


# ---------------------------------------------------------------------------
# Serving on the card (no kernel of its own: the engine, the caches and the
# masked decode attention, against the CPU port)
# ---------------------------------------------------------------------------


def test_decode_attention_ignores_garbage_on_card(card):
    """Positions past kv_len hold huge finite garbage: the card's output is
    the same bits as with zeros there (softmax weight exactly 0)."""
    from repro_torch.models.layers import decode_attention
    g = torch.Generator(device=card).manual_seed(0)
    B, T, hq, hkv, hd = 8, 256, 32, 8, 128
    q = torch.randn(B, 1, hq, hd, generator=g, device=card)
    k = torch.randn(B, T, hkv, hd, generator=g, device=card)
    v = torch.randn(B, T, hkv, hd, generator=g, device=card)
    lens = torch.randint(1, T + 1, (B,), generator=g, device=card)
    valid = (torch.arange(T, device=card)[None] < lens[:, None])[..., None,
                                                                 None]
    junk = torch.full_like(k, 1e18)
    clean = decode_attention(q, torch.where(valid, k, 0.0),
                             torch.where(valid, v, 0.0), lens)
    dirty = decode_attention(q, torch.where(valid, k, junk),
                             torch.where(valid, v, junk * 3e19), lens)
    assert torch.equal(clean, dirty) and torch.isfinite(dirty).all()


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b", "rwkv6-7b",
                                  "granite-moe-3b-a800m"])
def test_serve_engine_card_matches_cpu(card, arch):
    """The smoke config's engine on the card and on the CPU from the same
    params: the same completions (tokens, finish, virtual times); on the
    card the paged and contiguous caches in lockstep, the valid KV
    bit-equal; no kernel of the sketch path launched."""
    import dataclasses

    import numpy as np
    from repro_torch.api import RunSpec
    from repro_torch.configs import SMOKES
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.flatten import init_flat_params, make_flat_spec
    from repro_torch.serve import Request, ServeEngine
    cfg = SMOKES[arch]
    fs = make_flat_spec(cfg, 1)
    segs = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, fs)
    base = RunSpec(smoke=True, arch=arch)
    spec = dataclasses.replace(base, serve=dataclasses.replace(
        base.serve, batch=3, block_size=4, max_len=16, prompt_len=8, gen=4))
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=tuple(int(x) for x in rng.integers(
        1, cfg.vocab_size, int(rng.integers(1, 8)))), max_new=4)
        for i in range(6)]

    def engine(dev, paged=True):
        sp = dataclasses.replace(spec, serve=dataclasses.replace(
            spec.serve, paged=paged))
        eng = ServeEngine(cfg, fs, {k: v.to(dev) for k, v in segs.items()},
                          sp)
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        return eng

    want = [dataclasses.asdict(c) for c in engine("cpu").run()]
    LAUNCHES.clear()
    ep, ec = engine(card), engine(card, paged=False)
    while ep.pending() or ec.pending():
        assert ep.step() == ec.step()
        kvp, _ = M.split_cache(ep.cache.gather())
        kvc, _ = M.split_cache(ec.cache.gather())
        for i, s in enumerate(ep.slots):
            if s is not None:
                for (_, a), (_, b) in zip(tree_leaves(kvp),
                                          tree_leaves(kvc)):
                    assert torch.equal(a[:, :, i, :s.pos],
                                       b[:, :, i, :s.pos])
    assert [dataclasses.asdict(c) for c in ep.run()] == want
    assert [dataclasses.asdict(c) for c in ec.run()] == want
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("mode", ["psum", "tree"])
def test_straggler_drop_exchange_on_card(card, mode):
    """The bucketed exchange with a straggler dropped (include [1, 0, 1,
    1]) at a mid size (d = 3,000,000 in two buckets, P = 4, k 12,000, R 5,
    W 2^14) on the card: every worker applies the same update; on each
    bucket's selection it is the live workers' sum of u = ef + g times
    P/live (rtol 1e-4 beyond the f32 rounding of that sum); the dropped
    worker's new EF is its u bit for bit and the live workers' is 0 on the
    selection; the update and the EF equal the CPU port's on the same
    inputs (the encode is exact, the selection the plain version's)."""
    from repro_torch.core import compression as comp
    from repro_torch.core.gs_sgd import exchange_bucketed
    p, d = 4, 3_000_000
    bc = comp.bucketize(comp.make("gs-sgd", k=12_000, rows=5, width=1 << 14,
                                  allreduce_mode=mode),
                        comp.even_bucket_sizes(d, 2))
    gen = torch.Generator(device=card).manual_seed(4)
    g = torch.randn((p, d), generator=gen, device=card).mul_(1e-3)
    spikes = torch.randint(0, d, (p, 3000), generator=gen, device=card)
    g.scatter_(1, spikes, torch.randn((p, 3000), generator=gen,
                                      device=card))
    ef = tuple(torch.randn((p, n), generator=gen, device=card).mul_(1e-4)
               for n in bc.spec.sizes)
    inc = torch.tensor([1.0, 0.0, 1.0, 1.0], device=card)
    LAUNCHES.clear()
    upd, ef_new, _ = exchange_bucketed(bc, ef, g, nworkers=p, include=inc)
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_encode"] == 2 * p
    assert all(torch.equal(upd[w], upd[0]) for w in range(p))
    live = torch.tensor([0, 2, 3], device=card)
    eps = torch.finfo(torch.float32).eps
    for b, (o, n) in enumerate(zip(bc.spec.offsets, bc.spec.sizes)):
        u = ef[b] + g[:, o:o + n]
        assert torch.equal(ef_new[b][1], u[1])
        sel = torch.nonzero(upd[0, o:o + n]).flatten()
        assert 0 < sel.numel() <= bc.parts[b].k
        terms = u.index_select(0, live).index_select(1, sel).double()
        want = terms.sum(0) * (4 / 3)
        err = (upd[0, o + sel].double() - want).abs()
        assert bool((err <= 1e-4 * want.abs() + 4 * eps * (4 / 3)
                     * terms.abs().sum(0)).all())
        for w in (0, 2, 3):
            assert not bool(ef_new[b][w].index_select(0, sel).any())
    cpu = exchange_bucketed(bc, tuple(e.cpu() for e in ef), g.cpu(),
                            nworkers=p, include=inc.cpu())
    torch.testing.assert_close(upd.cpu(), cpu[0], rtol=1e-6, atol=1e-6)
    for e_card, e_cpu in zip(ef_new, cpu[1]):
        assert torch.equal((e_card == 0).cpu(), e_cpu == 0)
        torch.testing.assert_close(e_card.cpu(), e_cpu, rtol=1e-6, atol=1e-6)


def test_tree_step_p3_with_a_drop_card_matches_cpu(card):
    """The smoke config's step on the Alg. 1 tree at P = 3 (odd: the tree
    parks the largest odd rank), three steps, worker 1 dropped in the
    second, on the card and on the CPU port from the same params and
    batches: losses within 1e-3, the selected coordinates (every worker's
    EF zero pattern) equal every step, the replicas' params bit-equal on
    both devices, the scores route's kernels launched on the card."""
    import numpy as np

    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import MeshAxes, make_state, make_train_step
    from repro_torch.data import LMStream
    from repro_torch.launch.train import shard_batch
    from repro_torch.models.flatten import init_flat_params
    from repro_torch.optim import make as make_opt
    cfg = SMOKES["qwen3-4b"]
    masks = [torch.ones(3), torch.tensor([1.0, 0.0, 1.0]), torch.ones(3)]
    runs = []
    for dev in (torch.device("cpu"), card):
        opt = make_opt("adamw", lr=2e-3)
        ts = make_train_step(cfg, MeshAxes(tp=1, data=3, tp_axis=None), opt,
                             compressor_name="gs-sgd",
                             compressor_kw=dict(k=4096, rows=5, width=8192,
                                                allreduce_mode="tree"),
                             buckets=2, remat=False, dtype=torch.float32,
                             device=dev)
        params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1,
                                  ts.fs)
        st = make_state({k: v.to(dev) for k, v in params.items()}, opt,
                        ts.compressor, ts.d_local, 3)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=12, seed=0)
        LAUNCHES.clear()
        losses, sel = [], []
        for step, inc in enumerate(masks):
            batch = shard_batch(stream.global_batch_at(step, dev), 3)
            st, m = ts.fn(st, batch, inc.to(dev))
            losses.append(float(m["loss"]))
            sel.append([(e == 0).cpu() for e in st["ef"]])
            assert all(torch.equal(v, v[:1].expand_as(v))
                       for v in st["params"].values())
        runs.append((losses, sel, dict(LAUNCHES)))
    (lc, sc, _), (lg, sg, counts) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    for a, b in zip(sc, sg):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for name in ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                 "topk_select"):
        assert counts.get(name, 0) == 2 * 3 * 3, name


# The sharded layouts' cells (tp = 2 x data = 2 at qwen3-4b's widths, 2
# layers; fsdp pod = 2 x data = 2 at yi-9b's, 2 layers): the buckets of a
# (rank, worker)'s d_local and of a worker's shard, under the main path's
# exchange (gs-SGD, 2 buckets, R = 5, k and W from d).
SHARD_CELLS = {"tp": ("qwen3_4b", dict(tp=2, data=2), "dp"),
               "fsdp": ("yi_9b", dict(tp=1, data=2, pod=2, tp_axis=None,
                                      pod_axis="pod"), "fsdp")}


def _shard_cell(name):
    import dataclasses
    import importlib

    from repro_torch.api import ExchangeSpec, SketchSpec
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.optim import make as make_opt
    mod, mesh, mode = SHARD_CELLS[name]
    cfg = dataclasses.replace(
        importlib.import_module(f"repro_torch.configs.{mod}").CONFIG,
        n_layers=2)
    spec = ExchangeSpec(compressor="gs-sgd", buckets=2, overlap=True,
                        allreduce_mode="psum",
                        sketch=SketchSpec(rows=5, width=None, k=None))
    return make_train_step(cfg, MeshAxes(**mesh), make_opt("adamw"),
                           dp_mode=mode, spec=spec, dtype=torch.float32,
                           device="cuda")


@pytest.mark.parametrize("cell", list(SHARD_CELLS))
def test_kernels_at_shard_bucket_shapes(card, cell):
    """The exact encode (accumulate + finish), the decode with its
    histogram and the select at each bucket's shape of the sharded cells
    (every bucket past 2^22: the decode route), bit-equal to plain."""
    ts = _shard_cell(cell)
    for b, part in enumerate(ts.compressor.parts):
        d = ts.compressor.spec.sizes[b]
        cfg, k = part.sketch, part.k
        gen = torch.Generator(device=card).manual_seed(b)
        g = torch.randn(d, generator=gen, device=card)
        g *= torch.exp(-20 * torch.rand(d, generator=gen, device=card))
        sk = sketch_encode(cfg, g)
        assert _bits_equal(sk, sketch_encode_plain(cfg, g))
        key, hist = sketch_decode_hist(cfg, sk, d)
        assert torch.equal(key, sketch_decode_plain(cfg, sk, d))
        assert torch.equal(hist, radix_hist_plain(key))
        v, i = topk_select(key, k, hist)
        v_p, i_p = topk_select_plain(key, k, hist)
        assert torch.equal(i, i_p) and _bits_equal(v, v_p)
        del g, sk, key, hist, v, i, v_p, i_p
        torch.cuda.empty_cache()


@pytest.mark.parametrize("layout", ["tp2_data2", "fsdp_pod2_data2"])
def test_sharded_smoke_steps_card_match_cpu(card, layout):
    """Two gs-SGD steps of qwen3-4b's smoke config at tp = 2 x data = 2
    and of yi-9b's in fsdp at pod = 2 x data = 2, card against CPU from
    the same params and batches: losses within 1e-5 (f32, TF32 off), the
    selected coordinates of every exchange group and bucket equal, the
    scores route's kernels launched once a worker, rank, bucket and
    step."""
    import numpy as np

    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.data import LMStream
    from repro_torch.launch.train import shard_batch
    from repro_torch.models.common import init_params
    from repro_torch.models.flatten import make_flat_spec, shard_segs
    from repro_torch.optim import make as make_opt
    arch, ma, mode = {
        "tp2_data2": ("qwen3-4b", MeshAxes(tp=2, data=2), "dp"),
        "fsdp_pod2_data2": ("yi-9b", MeshAxes(tp=1, data=2, pod=2,
                                               tp_axis=None, pod_axis="pod"),
                            "fsdp")}[layout]
    cfg = SMOKES[arch]
    glob = init_params(cfg, torch.Generator().manual_seed(0), ma.tp)
    params = (shard_segs(cfg, glob, ma.tp)[1] if ma.tp > 1
              else make_flat_spec(cfg, 1).flatten(glob))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    try:
        for dev in (torch.device("cpu"), card):
            opt = make_opt("adamw", lr=1e-3)
            ts = make_train_step(cfg, ma, opt, dp_mode=mode,
                                 compressor_name="gs-sgd",
                                 compressor_kw=dict(k=2048, rows=5,
                                                    width=4096),
                                 buckets=2, dtype=torch.float32, device=dev)
            st = ts.state_from({k: v.to(dev) for k, v in params.items()},
                               opt)
            stream = LMStream(vocab_size=cfg.vocab_size, seq_len=16,
                              global_batch=2 * ts.nworkers, seed=0)
            LAUNCHES.clear()
            losses, sel = [], []
            for step in range(2):
                st, m = ts.fn(st, shard_batch(
                    stream.global_batch_at(step, dev), ts.nworkers))
                losses.append(float(m["loss"]))
                sel.append([(e == 0).cpu() for e in flatten(st["ef"])[0]])
            runs.append((losses, sel, dict(LAUNCHES)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, sc, _), (lg, sg, counts) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for a, b in zip(sc, sg):
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    for name in ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                 "topk_select"):
        assert counts.get(name, 0) == ma.tp * ma.dp_size * 2 * 2, name


def test_mesh_smoke_step_card_bit_equal_to_simulation(card):
    """Two processes share the card (gloo: every collective staged through
    pinned host memory), qwen3-4b smoke, gs-SGD psum at P = 2, buckets 2,
    three steps: losses, params and EF bit-equal to the simulated P = 2
    step on the card (every sum is two-way; each process runs its
    worker's kernels at the simulation's shapes), the encode, its finish,
    the scores kernel and the select launched by each process."""
    import os
    import sys

    import numpy as np

    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import MeshAxes
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.flatten import init_flat_params
    # the rank bodies' module by its own name (the spawned ranks import it
    # so; a site package named ``tests`` may shadow this directory)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_mesh_ranks import build_step, run_cases, run_steps, train_params
    build.build_all(["sketch_encode", "heavymix_scores", "sketch_decode",
                     "topk_select"])
    cfg = SMOKES["qwen3-4b"]
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, cfg.vocab_size, (4, 16)) for _ in range(3)]
    case = dict(kind="train", shape=(1, 2, 1), axes=("pod", "data", "model"),
                arch="qwen3-4b", opt=("adamw", dict(lr=2e-3)),
                kw=dict(compressor_kw=dict(k=2048, rows=5, width=4096),
                        buckets=2), device="cuda",
                batches=[{"tokens": t, "labels": t} for t in toks])
    ma = MeshAxes(tp=1, data=2, pod=1, tp_axis="model", data_axis="data",
                  pod_axis="pod")
    opt, ts = build_step(case, ma)
    case["params"] = {k: v.numpy() for k, v in init_flat_params(
        cfg, torch.Generator().manual_seed(0), 1, ts.fs).items()}
    _, sim = run_steps(ts, ts.state_from(train_params(case, ts, ma), opt),
                       case["batches"])
    torch.cuda.empty_cache()
    res = spawn(run_cases, 2, [case], device_type="cuda", timeout_s=300)
    for (out,) in res:
        w = out["worker"]
        assert out["backend"] == "gloo"
        assert out["loss"] == sim["loss"]
        for k, v in out["params"].items():
            assert torch.equal(v[0].view(torch.int32),
                               sim["params"][k][w].view(torch.int32)), k
        for me, se in zip(out["ef"], sim["ef"]):
            for x, y in zip(me, se):
                assert torch.equal(x[0].view(torch.int32),
                                   y[w].view(torch.int32))
        for name in ("sketch_encode", "sketch_encode_finish",
                     "heavymix_scores", "topk_select"):
            assert out["launches"].get(name, 0) == 2 * 3, (name,
                                                           out["launches"])
