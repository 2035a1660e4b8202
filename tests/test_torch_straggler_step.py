"""Port parity: a straggler drop through the whole train step,
``make_train_step(...).fn(state, batch, include)``, against the JAX
package's ``jax.vmap(ts.fn, in_axes=(0, 0, 0))`` on the same numpy params
and batches, for every exchange path: monolithic and bucketed (skewed)
here; backward-interleaved with and without the fused encode in
tests/test_torch_straggler_interleave.py; microbatch accumulation and
HEAVYMIX's faithful fill in tests/test_torch_straggler_fill.py (the
monolithic step on the Alg. 1 tree runs its drop in
tests/test_torch_elastic.py). Under psum and the tree. (Three files, so
that ``--dist loadfile`` spreads the reference's compiles.)

The smoke config of qwen3-4b, P = 4, global batch 8, seq 16, gs-SGD k
4096, R 5, W 8192, AdamW: step 0 drops worker 2 (include [1, 1, 0, 1]),
step 1 includes every worker. Held as tests/test_torch_elastic.py: losses
at rtol 1e-4, the selected coordinates (every worker's EF zero pattern)
equal, the EF at rtol 1e-4 / atol 1e-6, the params at rtol 1e-4 / atol
1e-6 but for its FLIPS allowance, and the replicas' params bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import compression as tcomp
from tests.test_torch_elastic import (batches, divergence, hold_params,
                                      hold_records, init_states, j_step,
                                      run_both, t_step)
from tests.test_torch_faithful import ref_filler

torch.set_num_threads(2)

P = 4
MASKS = (np.array([1, 1, 0, 1], np.float32), np.ones(4, np.float32))
VARIANTS = {
    "monolithic-psum": dict(kw=dict(allreduce_mode="psum")),
    "bucketed-tree": dict(buckets=2),
    "interleaved-fused-psum": dict(buckets=4, bwd_chunks=2,
                                   fuse_encode=True,
                                   kw=dict(allreduce_mode="psum")),
    "interleaved-tree": dict(buckets=4, bwd_chunks=2),
    "microbatch-psum": dict(buckets=2, microbatch=1,
                            kw=dict(allreduce_mode="psum")),
    "faithful-tree": dict(buckets=2, kw=dict(faithful_heavymix=True)),
}


def _kw(name):
    v = VARIANTS[name]
    return {k: (dict(x) if isinstance(x, dict) else x) for k, x in v.items()}


def check_variant(name, monkeypatch):
    if "faithful" in name:
        monkeypatch.setattr(tcomp, "draw_filler",
                            lambda n, dev: torch.from_numpy(
                                ref_filler(n).copy()).to(dev))
    jts, jfn, jopt = j_step(P, **_kw(name))
    tts, topt = t_step(P, **_kw(name))
    assert tts.d_local == jts.d_local
    if "interleaved" in name:
        assert tts.plan is not None and tts.bwd_chunks == 2
    js, ts_ = init_states(jts, jopt, tts, topt, P)
    recs = []
    for gb, inc in zip(batches(2, global_batch=8, seq=16), MASKS):
        js, ts_, rec = run_both(jfn, js, tts, ts_, gb, P, inc)
        assert np.isfinite(rec["t_loss"])
        recs.append(rec)
    # step 0's dropped worker holds its whole error-corrected gradient:
    # fewer zeros than any live worker's residual
    for te in recs[0]["t_ef"]:
        assert (te[2] == 0).sum() < (te[0] == 0).sum()
    hold_records(recs, range(2), tag=name)
    hold_params({k: np.asarray(v) for k, v in js["params"].items()},
                ts_["params"])
    assert divergence(ts_["params"]) == 0.0
    assert divergence(js["params"]) == 0.0
    jax.clear_caches()


@pytest.mark.parametrize("name", ["monolithic-psum", "bucketed-tree"])
def test_masked_step_equals_the_reference(name, monkeypatch):
    check_variant(name, monkeypatch)
