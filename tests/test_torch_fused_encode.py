"""Port parity for the fused encode of the backward interleave:
``GsSGD.can_fuse``, ``stage_encode_partial`` and ``stage_encode_merge`` on
the port's (P, n) layout, the fused step (``make_train_step(...,
bwd_chunks=K, fuse_encode=True)``), the exchange-config checks and the
train CLI, against the JAX package and against the port's unfused step.

Tolerances: EF adds are elementwise, so u is bit-equal. Partial sketches
summed after the fact add the same terms in another grouping than one
encode, so sketches are held at rtol = atol = 1e-4 (as
``tests/test_fused_encode.py`` holds the reference's); against the
reference's sketch the same. Fused against unfused steps: params at rtol
1e-5 / atol 1e-6 (the reference's bound for the same comparison) and the
selected coordinates equal. Against the reference's fused step, as
``tests/test_torch_gs_sgd.py``: losses at rtol 1e-4, selections equal,
EF and params at rtol 1e-4 / atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JSpec
from repro.core import compression as jcomp
from repro.launch.train import build as j_build
from repro_torch.api import RunSpec as TSpec
from repro_torch.api import SketchSpec
from repro_torch.core import compression as tcomp
from repro_torch.core.count_sketch import ExactSketch
from repro_torch.core.gs_sgd import MeshAxes, make_train_step
from repro_torch.kernels.sketch_encode import SCRATCH_BYTES, encode_plan
from repro_torch.launch import train as ttrain
from repro_torch.models import flatten as tfl
from repro_torch.optim import make as make_opt
from tests.test_torch_gs_sgd import SPEC, _run
from tests.test_torch_readiness import _cell_shapes, _port_run

_FRAGS = ((0, 1500), (1500, 2000), (2000, 4096))


def _pair(**kw):
    return (jcomp.make("gs-sgd", k=256, rows=3, width=512, **kw),
            tcomp.make("gs-sgd", k=256, rows=3, width=512, **kw))


def _ug(p=2, d=4096, seed=0):
    rng = np.random.default_rng(seed)
    return (0.01 * rng.standard_normal((p, d))).astype(np.float32), \
        rng.standard_normal((p, d)).astype(np.float32)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_partial_merge_matches_whole_and_reference(wire):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[wire]
    jc = jcomp.make("gs-sgd", k=256, rows=3, width=512, wire_dtype=jdt)
    tc = tcomp.make("gs-sgd", k=256, rows=3, width=512, wire_dtype=tdt)
    acc, g = _ug()
    acc_t, g_t = torch.from_numpy(acc), torch.from_numpy(g)
    u_w, sk_w = tc.stage_encode(acc_t, g_t)
    frags = [(lo,) + tc.stage_encode_partial(acc_t[:, lo:hi], g_t[:, lo:hi],
                                             lo) for lo, hi in _FRAGS]
    assert all(isinstance(f[2], ExactSketch)
               and f[2].limbs.dtype == torch.int64
               and f[2].limbs.shape == (2, 3, 3, 512)
               and f[2].flags.shape == (2, 3, 512) for f in frags)
    u_m, sk_m = tc.stage_encode_merge(frags[::-1])   # any order
    assert torch.equal(u_m, u_w) and sk_m.dtype == tdt
    np.testing.assert_allclose(sk_m.float().numpy(), sk_w.float().numpy(),
                               rtol=1e-4, atol=1e-4)
    for p in range(2):
        jf = [(lo,) + jc.stage_encode_partial(jnp.asarray(acc[p, lo:hi]),
                                              jnp.asarray(g[p, lo:hi]), lo)
              for lo, hi in _FRAGS]
        ju, jsk = jc.stage_encode_merge(jf)
        np.testing.assert_array_equal(u_m[p].numpy(), np.asarray(ju))
        np.testing.assert_allclose(
            sk_m[p].float().numpy(), np.asarray(jsk, dtype=np.float32),
            rtol=1e-4, atol=1e-4)


def test_merge_of_one_fragment_is_the_whole_encode():
    _, tc = _pair()
    acc, g = _ug(seed=2)
    acc_t, g_t = torch.from_numpy(acc), torch.from_numpy(g)
    u_w, sk_w = tc.stage_encode(acc_t, g_t)
    u_m, sk_m = tc.stage_encode_merge(
        [(0,) + tc.stage_encode_partial(acc_t, g_t, 0)])
    assert torch.equal(u_m, u_w) and torch.equal(sk_m, sk_w)


@pytest.mark.parametrize("frags", [((0, 1000), (1200, 2200)),   # a gap
                                   ((0, 1000), (900, 2000)),    # overlap
                                   ((100, 1000),)])             # late start
def test_merge_rejects_a_bad_tiling_like_the_reference(frags):
    jc, tc = _pair()
    acc, g = _ug(seed=3)
    msgs = []
    for c, z, arr, part in (
            (tc, torch.zeros, torch.from_numpy(g),
             lambda x, lo, hi: x[:, lo:hi]),
            (jc, jnp.zeros, jnp.asarray(g[0]), lambda x, lo, hi: x[lo:hi])):
        pieces = []
        for lo, hi in frags:
            piece = part(arr, lo, hi)
            pieces.append((lo,) + c.stage_encode_partial(
                z(piece.shape), piece, lo))
        with pytest.raises(ValueError, match="do not tile the bucket") as e:
            c.stage_encode_merge(pieces)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("encoder,fuses", [("exact", True), ("ts", False)])
def test_can_fuse_only_exact_encoder(encoder, fuses):
    jc, tc = _pair(encoder=encoder)
    assert tc.can_fuse is jc.can_fuse is fuses


@pytest.mark.parametrize("chunks", [1, 2])
def test_fused_matches_unfused(chunks):
    unfused, u_loss, _ = _port_run(4, bwd_chunks=chunks)
    fused, f_loss, ts = _port_run(4, bwd_chunks=chunks, fuse_encode=True)
    assert ts.fuse_encode is True and ts.bwd_chunks == chunks
    np.testing.assert_allclose(f_loss, u_loss, rtol=1e-5)
    for a, b in zip(fused["ef"], unfused["ef"]):
        assert torch.equal(a == 0, b == 0)
    for k, v in fused["params"].items():
        np.testing.assert_allclose(v.numpy(), unfused["params"][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_ts_encoder_keeps_the_whole_bucket_encode():
    """fuse_encode with the TS encoder: no bucket can fuse, so each bucket
    assembles its slices and runs the whole-bucket TS encode; the step is
    the unfused interleave's, bit for bit."""
    spec = TSpec.load(SPEC)
    out = []
    for fuse in (False, True):
        ts = make_train_step(
            spec.arch_config(), spec.mesh_axes(), spec.make_optimizer(),
            compressor_name="gs-sgd",
            compressor_kw=dict(k=256, rows=3, width=512, encoder="ts"),
            buckets=4, bwd_chunks=2, fuse_encode=fuse, device="cpu")
        st = ts.init_state(spec.make_optimizer(),
                           torch.Generator().manual_seed(0))
        t = torch.from_numpy(np.random.default_rng(4).integers(
            0, spec.arch_config().vocab_size, (2, 2, spec.seq)))
        st, _ = ts.fn(st, {"tokens": t, "labels": t})
        out.append(st)
    for k in out[0]["params"]:
        assert torch.equal(out[0]["params"][k], out[1]["params"][k]), k


def test_fused_matches_reference_fused_step():
    """Two fused steps at buckets 4, K 2 against the JAX package's fused
    interleaved step, from the reference's params and batches."""
    jspec, tspec = JSpec.load(SPEC), TSpec.load(SPEC)
    ex = dict(buckets=4, bwd_chunks=2, fuse_encode=True)
    jspec = dataclasses.replace(jspec, exchange=dataclasses.replace(
        jspec.exchange, **ex))
    tspec = dataclasses.replace(tspec, exchange=dataclasses.replace(
        tspec.exchange, **ex))
    _, opt, _, jts = j_build(jspec)
    _, topt, _, tts = ttrain.build(tspec, "cpu")
    assert jts.fuse_encode is tts.fuse_encode is True
    out = _run(jspec, jts, opt, tts, topt)
    np.testing.assert_allclose(out["t_loss"], out["j_loss"], rtol=1e-4)
    for step, (jefs, tefs) in enumerate(zip(out["j_ef"], out["t_ef"])):
        for b, (je, te) in enumerate(zip(jefs, tefs)):
            np.testing.assert_array_equal(te == 0, je == 0,
                                          err_msg=f"step {step} bucket {b}")
            np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-6)
    for k, v in out["t_params"].items():
        np.testing.assert_allclose(v, out["j_params"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(compressor_name="topk", fuse_encode=True, buckets=4, bwd_chunks=2),
    dict(fuse_encode=True, buckets=4),
    dict(fuse_encode=True, bwd_chunks=2),
    dict(fuse_encode=True, buckets=4, bwd_chunks=2, overlap=False)])
def test_unfusable_configs_raise_like_reference(kw):
    from repro.core import gs_sgd as jgs
    from repro.optim import make as j_make_opt
    msgs = []
    for make, opt, ma, extra in (
            (jgs.make_train_step, j_make_opt("adamw", lr=1e-3),
             jgs.MeshAxes(tp=1, data=2, tp_axis=None), {}),
            (make_train_step, make_opt("adamw", lr=1e-3),
             MeshAxes(tp=1, data=2, tp_axis=None), {"device": "cpu"})):
        cfg = (JSpec if make is jgs.make_train_step
               else TSpec).load(SPEC).arch_config()
        with pytest.raises(ValueError, match="fuse_encode") as e:
            make(cfg, ma, opt, **kw, **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cli_runs_fused_interleave_on_cpu(capsys):
    out = ttrain.main(["--spec", SPEC, "--device", "cpu", "--steps", "2",
                       "--buckets", "4", "--bwd-chunks", "2",
                       "--fuse-encode"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1].startswith('{"final_loss": ')
    assert ("backward-interleaved readiness: 2 chunk(s), bucket readiness "
            "[2, 1, 1, 0], fuse_encode=on") in printed
    assert len(out["history"]) == 2 and np.isfinite(out["final_loss"])


def cell_fragments():
    """The full-width cell's fused fragments (qwen3-4b, 2 layers, buckets
    4, K 2), per bucket: (offset in the bucket, length)."""
    plan = tfl.bucket_plan(_cell_shapes(), 4, 2)
    return plan, [sorted(f) for f in plan.fragments()]


def test_encode_plan_handles_the_cell_fragments():
    """Per worker: bucket 0 one piece, bucket 1 three (the top_s tail,
    top_r, cycle row 0 of cycles_s), bucket 2 two (cycles_s row 1,
    cycles_r row 0), bucket 3 one: 7 partial encodes, 14 a step at P = 2.
    ``encode_plan`` gives each a launch within the scratch bound."""
    plan, frags = cell_fragments()
    assert frags == [[(0, 259_304_107)],
                     [(0, 129_652_053), (129_652_053, 2_560),
                      (129_654_613, 100_925_440)],
                     [(0, 100_925_440), (100_925_440, 5_632)],
                     [(0, 5_632)]]
    d = sum(plan.sizes)
    sk = SketchSpec(rows=5, width=None, k=None).resolve(d)
    bc = tcomp.bucketize(tcomp.make("gs-sgd", k=sk.k, rows=sk.rows,
                                    width=sk.width), plan.sizes)
    for part, fr, size in zip(bc.parts, frags, plan.sizes):
        assert sum(n for _, n in fr) == size
        for _, n in fr:
            ep = encode_plan(part.sketch.rows, part.sketch.log2_width, n)
            assert ep.scratch_bytes <= SCRATCH_BYTES
            assert 1 <= ep.chunk <= n and ep.nblocks * ep.block >= ep.chunk
