"""The top-k radix select's slabbed passes (``csrc/topk_select.cu``) as a
numpy model, against ``core.heavymix.topk_lower_index`` and the
reference's ``jax.lax.top_k``, on numpy keys made from a seed.

The card's select reads all n keys once: after the digit-1 search each
CTA (a contiguous chunk from ``select_plan``) writes its keys above the
digit-1 bin b1, counts digit 2 of its keys in b1 and keeps their
composites, in index order, in a slab of ``capacity`` slots; each of its 8
warps takes an eighth of the chunk and of the slab (a segment). Digit 3,
the keys of b1 above the k-th key v and the ties at v then read the slabs;
a segment whose b1 keys outnumber its slots (an overflow) is read from x
instead, and where b1 holds more keys than all the slots together the
slabs are off: every segment is read from x and the output pass writes
every key above v. The ties are written by rank: the lower CTAs' ties first, then
index order. ``_slab_select`` repeats those passes CTA by CTA, so the
tests pin that the design selects exactly what ``jax.lax.top_k`` selects
(indices equal as returned, values bit-equal) whatever the capacity:
the slabs alone, some CTAs overflowed, or all. The kernels themselves run
only on a card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.heavymix import topk_lower_index
from repro_torch.kernels.topk_select import (radix_hist_plain, select_plan,
                                             slab_capacity, topk_select)

_SMS = 2   # a small card: 16 CTAs at most, so chunks of a few thousand keys
_SEGMENTS = 8   # a CTA's segments, one a warp


def _search(hist, need):
    """The bin, from the top, that holds the need-th largest key, and how
    many of its keys are still needed (``search_kernel``)."""
    above = 0
    for b in range(hist.shape[0] - 1, -1, -1):
        if need <= above + hist[b]:
            return b, need - above
        above += int(hist[b])
    raise AssertionError("fewer keys than need")


def _composite(u, i):
    return ((0x7FFFFFFF - u.astype(np.uint64)) << np.uint64(32)) | \
        i.astype(np.uint64)


def _slab_select(x, k, capacity=None, sms=_SMS):
    """The card's passes over float32 ``x`` segment by segment: (values,
    indices) in ``jax.lax.top_k``'s order, and the CTAs with an overflowed
    segment. Segment s of CTA b is warp s's eighth of the CTA's chunk, with
    an eighth of its slab."""
    u = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
    n = u.shape[0]
    grid, chunk = select_plan(n, sms)
    cap = slab_capacity(chunk) if capacity is None else capacity
    seg, capw = chunk // _SEGMENTS, cap // _SEGMENTS
    nseg = grid * _SEGMENTS
    hist1 = np.bincount(u >> 20, minlength=2048)
    b1, need = _search(hist1, k)
    off = hist1[b1] > grid * cap   # more bin keys than all slots
    out, slabs, counts = [], [], []
    hist2 = np.zeros(2048, np.int64)

    def keys(g):   # segment g's keys in x and their indices
        lo = min(n, g * seg)
        cu = u[lo:min(n, lo + seg)]
        return cu, np.arange(lo, lo + cu.shape[0], dtype=np.uint32)

    for g in range(nseg):
        cu, ci = keys(g)
        d1 = cu >> 20
        if not off:   # with the slabs off, the output pass writes these
            out.append(_composite(cu[d1 > b1], ci[d1 > b1]))
        inb = d1 == b1
        hist2 += np.bincount((cu[inb] >> 9) & 2047, minlength=2048)
        counts.append(int(inb.sum()))
        slabs.append(_composite(cu[inb], ci[inb])[:capw])
    overflowed = [off or c > capw for c in counts]

    def source(g):
        if not overflowed[g]:
            c = slabs[g]
            return ((0x7FFFFFFF - (c >> np.uint64(32))).astype(np.uint32),
                    (c & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        return keys(g)

    b2, need = _search(hist2, need)
    prefix = (b1 << 11) | b2
    hist3 = np.zeros(512, np.int64)
    for g in range(nseg):
        ku, _ = source(g)
        hist3 += np.bincount(ku[(ku >> 9) == prefix] & 511, minlength=512)
    b3, need = _search(hist3, need)
    v = (prefix << 9) | b3
    ties = []
    for g in range(nseg):
        ku, ki = source(g)
        win = (ku > v) & (off | ((ku >> 20) == b1))
        out.append(_composite(ku[win], ki[win]))
        ties.append(int((ku == v).sum()))
    rank = 0   # CTA by CTA (the lower CTAs' ties), then its segments in order
    for g in range(nseg):
        if ties[g] and rank < need:
            ku, ki = source(g)
            at = ki[ku == v][:need - rank]
            out.append(_composite(np.full(at.shape, v, np.uint32), at))
        rank += ties[g]
    comp = np.sort(np.concatenate(out))
    assert comp.shape == (k,)
    vals = (0x7FFFFFFF - (comp >> np.uint64(32))).astype(np.uint32)
    ctas_over = np.asarray(overflowed).reshape(grid, _SEGMENTS).any(1)
    return (vals.view(np.float32), (comp & np.uint64(0xFFFFFFFF))
            .astype(np.int64), int(ctas_over.sum()))


def _check(x, k, capacity=None):
    """The model against topk_lower_index(|x|) and jax.lax.top_k(|x|), and
    the wrapper (plain on the CPU) against both; returns the overflowed
    CTAs."""
    xt = torch.from_numpy(x)
    want_v, want_i = topk_lower_index(xt.abs(), k)
    jv, ji = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    np.testing.assert_array_equal(want_i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(want_v.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    v, i, n_over = _slab_select(x, k, capacity)
    np.testing.assert_array_equal(i, want_i.numpy())
    np.testing.assert_array_equal(v.view(np.uint32),
                                  want_v.numpy().view(np.uint32))
    tv, ti = topk_select(xt, k, radix_hist_plain(xt), capacity=capacity)
    np.testing.assert_array_equal(ti.numpy(), want_i.numpy())
    np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                  want_v.numpy().view(np.uint32))
    return n_over


def _heavy_ties(n, seed, dense_until, dense=0.9, sparse=0.02):
    """HEAVYMIX scores of the TS route: every heavy score is exactly 1e30
    (|est| + 1e30 rounds to it), heavy at share ``dense`` below index
    ``dense_until`` and ``sparse`` above it."""
    rs = np.random.RandomState(seed)
    s = np.abs(rs.randn(n)).astype(np.float32) * np.float32(1e-3)
    share = np.where(np.arange(n) < dense_until, dense, sparse)
    heavy = rs.rand(n) < share
    s[heavy] = s[heavy] + np.float32(1e30)
    assert (s[heavy] == np.float32(1e30)).all()
    return s


def test_model_geometry():
    """The model's CTAs and slab: 13 chunks of 4096 keys, 2048 slots (8
    segments of 512 keys and 256 slots)."""
    grid, chunk = select_plan(50_000, _SMS)
    assert (grid, chunk, slab_capacity(chunk)) == (13, 4096, 2048)


@pytest.mark.parametrize("capacity,overflow", [
    (None, "some"), (0, "all"), (32, "all"), (1024, "some"),
    (4096, "none")])
@pytest.mark.parametrize("k", [1, 600, 5000, 8000])
def test_all_keys_tied_above_k(capacity, overflow, k):
    """The TS case: the heavy keys (all exactly 1e30) outnumber k, so the
    k-th key is a tie and the lowest-index heavy keys win; dense in the
    first two chunks (their slabs overflow at the default capacity)."""
    x = _heavy_ties(50_000, k, dense_until=8192)
    assert (x == np.float32(1e30)).sum() > k
    n_over = _check(x, k, capacity)
    grid = select_plan(50_000, _SMS)[0]
    want = {"none": 0, "all": grid, "some": None}[overflow]
    if want is None:
        assert 0 < n_over < grid
    else:
        assert n_over == want


@pytest.mark.parametrize("k", [1, 5000, 40_000])
def test_bin_larger_than_all_slabs_turns_them_off(k):
    """Most keys tie at 1e30 (the TS scores at W = 16,384): the first
    digit's bin outnumbers all the slabs' slots, so no slab is written and
    every CTA reads its keys in x; the selection is the same."""
    x = _heavy_ties(50_000, k, dense_until=50_000, dense=0.86)
    grid, chunk = select_plan(50_000, _SMS)
    assert (x == np.float32(1e30)).sum() > grid * slab_capacity(chunk)
    assert _check(x, k) == grid


@pytest.mark.parametrize("capacity", [None, 0, 1024])
@pytest.mark.parametrize("k", [9000, 30_000])
def test_heavy_set_below_k(capacity, k):
    """Fewer heavy keys than k: every 1e30 key goes out in the first pass
    (above the digit-1 bin), and the rest come from the small keys."""
    x = _heavy_ties(50_000, k, dense_until=8192)
    assert (x == np.float32(1e30)).sum() < k
    _check(x, k, capacity)


@pytest.mark.parametrize("capacity", [None, 0, 32, 64])
@pytest.mark.parametrize("k", [1, 37, 2500, 49_999])
def test_est_like_keys(capacity, k):
    """|est|-like keys, many repeated (medians of a few sketch cells)."""
    rs = np.random.RandomState(k)
    cells = (0.1 * rs.randn(1000)).astype(np.float32)
    x = cells[rs.randint(0, 1000, 50_000)]
    x[rs.choice(50_000, 8, replace=False)] = 10.0 * rs.randn(8)
    _check(x, k, capacity)


@pytest.mark.parametrize("capacity", [None, 0, 32])
@pytest.mark.parametrize("k", [1, 5, 6, 40, 5000])
def test_nan_keys(capacity, k):
    """NaN keys rank above +inf, by index (jax.lax.top_k's order), and
    -NaN as NaN; the NaN bin is the top digit-1 bin."""
    rs = np.random.RandomState(k)
    x = rs.randn(50_000).astype(np.float32)
    nan_at = rs.choice(50_000, 6, replace=False)
    x[nan_at] = np.nan
    x[nan_at[0]] = -np.nan
    x[rs.choice(50_000, 3, replace=False)] = np.inf
    _check(x, k, capacity)


@pytest.mark.parametrize("capacity", [None, 0])
def test_k_one_below_n(capacity):
    """k = n - 1: only the least key (by value, then the highest index)
    is left out."""
    rs = np.random.RandomState(3)
    x = rs.randn(20_000).astype(np.float32)
    x[rs.choice(20_000, 5000, replace=False)] = 0.5
    _check(x, 19_999, capacity)


def test_k_at_least_n_selects_everything():
    """k >= n launches nothing on the card and returns every key in
    jax.lax.top_k's order; the wrapper takes that route on either device."""
    rs = np.random.RandomState(4)
    x = rs.randn(3000).astype(np.float32)
    xt = torch.from_numpy(x)
    for k in (3000, 3500):
        v, i = topk_select(xt, k, radix_hist_plain(xt), capacity=0)
        want_v, want_i = topk_lower_index(xt.abs(), k)
        assert torch.equal(i, want_i) and torch.equal(v, want_v)
    jv, ji = jax.lax.top_k(jnp.abs(jnp.asarray(x)), 3000)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("capacity", [-32, 6, 16])
def test_capacity_must_be_a_multiple_of_32(capacity):
    """Each of a CTA's 8 segments is read 32 bytes a thread: the wrapper
    refuses capacities that are not multiples of 32, on either device."""
    x = torch.ones(5000)
    with pytest.raises(ValueError):
        topk_select(x, 10, torch.zeros(2048, dtype=torch.int32),
                    capacity=capacity)
