"""The port's exact Count-Sketch encode (``core/count_sketch.py``:
``ExactSketch``, ``encode_into``, ``finish``; the card's
``csrc/sketch_encode.cu`` repeats it, held bit-equal on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``).

Each contribution v = sign_r(i) * g[i] is summed as the integer
sign(v) * floor(|v| * 2^64) in three int64 limbs, and each cell is rounded
to f32 once. Tolerances:
- against the JAX package's ``cs.encode`` and its Pallas encode (interpret
  mode): 1e-4 * max|S| (the reference sums in f32 in its own order; the
  exact sum rounded once is at least as close to the true sum);
- against a numpy model of the limb arithmetic (Python integers): bit-equal;
- fragments of any cutting, summed in any order, against the whole
  encode: bit-equal; so are the fused and the bucketed(4) smoke runs;
- non-finite input: NaN and +-inf cells where the reference has them (its
  f32 sum), finite cells within 1e-4 * max|S|; an element with |v| >= 2^31
  makes its cells NaN (by design: the limbs cannot hold it).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro.kernels.sketch_encode import sketch_encode as pallas_encode
from repro_torch.core import compression as tcomp
from repro_torch.core import count_sketch as tcs
from repro_torch.kernels import ops
from repro_torch.kernels import sketch_encode as ske
from tests.test_torch_readiness import _port_run

M32 = 0xFFFFFFFF


def _cfgs(rows, width, seed):
    return (jcs.SketchConfig(rows=rows, width=width, seed=seed),
            tcs.SketchConfig(rows=rows, width=width, seed=seed))


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _grad(d, seed):
    """Gradient-like f32: small noise over 12 decades of magnitude, both
    signs, a few spikes."""
    rs = np.random.default_rng(seed)
    g = rs.standard_normal(d) * 10.0 ** rs.uniform(-12, 0, d)
    g[rs.choice(d, max(1, d // 100), replace=False)] *= 1e3
    return g.astype(np.float32)


@pytest.mark.parametrize("d,offset", [(3001, 0), (2500, 2**31 - 777)])
@pytest.mark.parametrize("rows,width", [(3, 256), (5, 1024), (1, 1)])
def test_encode_matches_reference_and_pallas(d, offset, rows, width):
    j, t = _cfgs(rows, width, 2)
    g = _grad(d, d + rows)
    got = tcs.encode(t, torch.from_numpy(g), offset=offset).numpy()
    lim = 1e-4 * float(np.abs(got).max())
    for want in (jcs.encode(j, jnp.asarray(g), offset=offset),
                 pallas_encode(j, jnp.asarray(g), index_offset=offset,
                               interpret=True)):
        want = np.asarray(want)
        assert float(np.abs(got - want).max()) <= lim


def _model(cfg, g, offset=0):
    """numpy/Python-integer model: each cell's exact integer sum T of
    sign(v) * floor(|v| * 2^64), then f32((f64(T >> 64) + f64((T >> 32)
    & M) * 2^-32) + f64(T & M) * 2^-64)."""
    hp = cfg.hash_params.astype(np.uint64)
    i = ((np.arange(len(g), dtype=np.uint64) + np.uint64(offset))
         & np.uint64(M32))
    hb = (hp[:, 0:1] * i + hp[:, 1:2]) & np.uint64(M32)
    bk = (hb >> np.uint64(32 - cfg.log2_width) if cfg.log2_width
          else np.zeros_like(hb)).astype(np.int64)
    hs = (hp[:, 2:3] * i + hp[:, 3:4]) & np.uint64(M32)
    sg = np.where(hs >> np.uint64(31), -1, 1)
    tot = [[0] * cfg.width for _ in range(cfg.rows)]
    for r in range(cfg.rows):
        for j, x in enumerate(g.tolist()):
            v = sg[r, j] * x
            tot[r][bk[r, j]] += int(math.copysign(
                math.floor(abs(v) * 2.0 ** 64), v)) if v else 0
    out = np.empty((cfg.rows, cfg.width), dtype=np.float32)
    for r in range(cfg.rows):
        for w, t in enumerate(tot[r]):
            a, b, c = t >> 64, (t >> 32) & M32, t & M32
            out[r, w] = np.float32((np.float64(a) + np.float64(b) * 2.0 ** -32)
                                   + np.float64(c) * 2.0 ** -64)
    return out


@pytest.mark.parametrize("rows,width,d,offset", [
    (3, 64, 900, 0), (2, 16, 700, 2**32 - 350), (1, 1, 1200, 5),
    (4, 1, 500, 0)])
def test_limb_arithmetic_matches_a_numpy_model(rows, width, d, offset):
    """W = 1: the whole vector lands in one cell per row. The values span
    subnormals to near 2^31, both signs."""
    _, t = _cfgs(rows, width, 9)
    g = _grad(d, rows * width)
    g[:6] = [2147483520.0, -2147483520.0, 1e-44, -3e-40, 1.5, -0.75]
    got = tcs.encode(t, torch.from_numpy(g), offset=offset).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_model(t, g, offset)))


@pytest.mark.parametrize("seed", range(4))
def test_fragments_in_any_order_are_bit_equal(seed):
    """A random cutting of g into offset fragments, encoded into separate
    exact sketches and summed in shuffled order, is bit-equal to the whole
    encode; so is ``stage_encode_merge`` of shuffled ``stage_encode_partial``
    fragments to ``stage_encode``."""
    rs = np.random.default_rng(seed)
    d = 5000
    cuts = np.sort(rs.choice(np.arange(1, d), 6, replace=False))
    bounds = list(zip([0, *cuts], [*cuts, d]))
    _, t = _cfgs(5, 512, seed)
    g = torch.from_numpy(_grad(d, seed))
    parts = []
    for lo, hi in bounds:
        acc = tcs.exact_zeros(t)
        ops.encode_into(t, g[lo:hi], acc, offset=lo)
        parts.append(acc)
    order = rs.permutation(len(parts))
    total = parts[order[0]]
    for i in order[1:]:
        total = total + parts[i]
    assert torch.equal(tcs.finish(total).view(torch.int32),
                       tcs.encode(t, g).view(torch.int32))

    c = tcomp.make("gs-sgd", k=200, rows=5, width=512, seed=seed)
    acc_ef = torch.from_numpy(np.stack([_grad(d, seed + 10)] * 2))
    g2 = torch.stack([g, -g])
    frags = [(lo,) + c.stage_encode_partial(acc_ef[:, lo:hi], g2[:, lo:hi],
                                            lo) for lo, hi in bounds]
    u_m, sk_m = c.stage_encode_merge([frags[i] for i in order])
    u_w, sk_w = c.stage_encode(acc_ef, g2)
    assert torch.equal(u_m, u_w)
    assert torch.equal(sk_m.view(torch.int32), sk_w.view(torch.int32))


def test_exact_sketch_stands_for_its_f32_sketch():
    """Workers' exact sketches (int64 limbs (P, 3, R, W), int32 flags
    (P, R, W)) finish, in one call, into each worker's f32 encode."""
    _, t = _cfgs(3, 256, 1)
    g = torch.from_numpy(_grad(2000, 1))
    acc = tcs.exact_zeros(t, (2,))
    assert acc.limbs.shape == (2, 3, 3, 256) and acc.limbs.dtype == torch.int64
    assert acc.flags.shape == (2, 3, 256) and acc.flags.dtype == torch.int32
    for p in range(2):
        ske.sketch_encode_into(t, (p + 1) * g, acc.worker(p))
    fin = ske.sketch_encode_finish(acc)
    assert fin.shape == (2, 3, 256) and fin.dtype == torch.float32
    for p in range(2):
        assert torch.equal(fin[p], tcs.encode(t, (p + 1) * g))
        assert torch.equal(fin[p], tcs.finish(acc.worker(p)))


def _planted(d, seed, plants):
    g = _grad(d, seed) * 1e-3
    for j, v in plants:
        g[j] = v
    return g


@pytest.mark.parametrize("case", ["nan", "pos_inf", "neg_inf", "both_inf"])
def test_nonfinite_cells_like_the_reference(case):
    """NaN, +inf, -inf, and +inf with -inf in one cell: the port's NaN and
    inf cells (with their signs) are the reference's; the other cells agree
    within 1e-4 * max|S|."""
    j, t = _cfgs(3, 64, 4)
    plants = {"nan": [(10, np.nan)], "pos_inf": [(10, np.inf)],
              "neg_inf": [(10, -np.inf)],
              "both_inf": [(10, np.inf), (11, -np.inf)]}[case]
    d = 800
    g = _planted(d, 3, plants)
    if case == "both_inf":  # put element 11 in element 10's row-0 cell
        bk, sg = tcs.hash_buckets(t, torch.arange(d))
        k = next(i for i in range(11, d)
                 if bk[0, i] == bk[0, 10] and sg[0, i] == sg[0, 10])
        g[11], g[k] = g[k], -np.inf
    got = tcs.encode(t, torch.from_numpy(g)).numpy()
    want = np.asarray(jcs.encode(j, jnp.asarray(g)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isnan(got).any() or np.isinf(got).any()
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]).max()
            <= 1e-4 * np.abs(want[fin]).max())
    if case == "both_inf":
        assert np.isnan(got[0, int(bk[0, 10])])


@pytest.mark.parametrize("big", [2.0 ** 31, -3e9, 1e38])
def test_out_of_range_element_makes_its_cells_nan(big):
    """|v| >= 2^31 cannot be held by the limbs: its R cells are NaN (the
    reference sums it); an infinity in the same cell still wins."""
    _, t = _cfgs(3, 64, 4)
    g = _planted(500, 5, [(7, big)])
    got = tcs.encode(t, torch.from_numpy(g)).numpy()
    bk, _ = tcs.hash_buckets(t, torch.tensor([7]))
    cells = {(r, int(bk[r, 0])) for r in range(3)}
    for r in range(3):
        for w in range(64):
            assert np.isnan(got[r, w]) == ((r, w) in cells)
    g2 = g.copy()
    g2[8] = np.inf
    bk2, sg2 = tcs.hash_buckets(t, torch.tensor([8]))
    got2 = tcs.encode(t, torch.from_numpy(g2)).numpy()
    for r in range(3):
        cell = got2[r, int(bk2[r, 0])]
        assert np.isinf(cell) and np.sign(cell) == float(sg2[r, 0])


def test_fused_and_bucketed_smoke_runs_are_bit_equal(monkeypatch):
    """The smoke spec at buckets 4: every fused merge (of several
    fragments, in 3 of the 4 buckets) is bit-equal to the whole-bucket
    encode of the same u, and the interleaved run with the fused encode
    (bwd_chunks 2) and the bucketed run give the same losses, selections
    (EF) and params, bit for bit: the partials stay exact until the
    merge."""
    seen = []
    merge = tcomp.GsSGD.stage_encode_merge

    def checked(self, pieces):
        u, sk = merge(self, pieces)
        whole = self._encode_workers(u).to(self.wire_dtype)
        seen.append((len(pieces), torch.equal(sk.view(torch.int32),
                                              whole.view(torch.int32))))
        return u, sk

    monkeypatch.setattr(tcomp.GsSGD, "stage_encode_merge", checked)
    fused, l_f, ts_f = _port_run(4, bwd_chunks=2, fuse_encode=True)
    assert len(seen) == 4 * 3 and sum(n > 1 for n, _ in seen) == 3 * 3
    assert all(eq for _, eq in seen)
    plain, l_p, _ = _port_run(4)
    assert ts_f.fuse_encode and l_f == l_p
    for a, b in zip(fused["ef"], plain["ef"]):
        assert torch.equal(a, b)
    for k in plain["params"]:
        assert torch.equal(fused["params"][k], plain["params"][k]), k


def test_encode_plan_overrides():
    plan = ske.encode_plan(5, 20, 388_956_160, splits=3, chunk=1 << 22)
    assert (plan.splits, plan.chunk) == (3, 1 << 22)
    assert plan.nblocks == (1 << 22) // plan.block
    with pytest.raises(ValueError):
        ske.encode_plan(5, 20, 10**6, chunk=1000)   # not a block multiple
    with pytest.raises(ValueError):
        ske.encode_plan(5, 20, 10**6, chunk=1 << 26)  # above the pass cap
