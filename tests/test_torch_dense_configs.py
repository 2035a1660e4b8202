"""Port parity: the dense architectures' configs (yi-9b, minicpm-2b,
starcoder2-3b), the registry's rows for all ten archs, the spec's
full-size train step and ``configs/shapes.py``.

The registry rows (ARCHS, SMOKES, DP_MODE, TRAIN_OVERRIDES) must equal
the reference's field for field. Two gs-SGD
steps of each new smoke config (examples/specs/qwen3_smoke.json with the
arch replaced: P = 2, buckets 2, psum, AdamW) run in both packages from the
reference's params and batches, as tests/test_torch_gs_sgd.py does for
qwen3-4b: losses at rtol 1e-4, the selected coordinates equal every step,
EF and params at rtol 1e-4 / atol 1e-6. minicpm-2b's smoke has tied
embeddings and a width of 60 (6 heads of 10); starcoder2-3b's has one KV
head.
"""

import dataclasses

import numpy as np
import pytest

from repro import configs as jconf
from repro.api import RunSpec as JSpec
from repro.configs import shapes as jshapes
from repro.launch.train import build as j_build
from repro_torch import configs as tconf
from repro_torch.api import RunSpec as TSpec
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import train as ttrain
from tests.test_torch_gs_sgd import SPEC, _run

NEW = ("yi-9b", "minicpm-2b", "starcoder2-3b")


@pytest.mark.parametrize("arch", sorted(jconf.ARCHS))
def test_registry_rows_equal_reference(arch):
    assert (dataclasses.asdict(tconf.ARCHS[arch])
            == dataclasses.asdict(jconf.ARCHS[arch]))
    assert (dataclasses.asdict(tconf.SMOKES[arch])
            == dataclasses.asdict(jconf.SMOKES[arch]))
    assert tconf.DP_MODE[arch] == jconf.DP_MODE[arch]
    assert tconf.get(arch) == tconf.ARCHS[arch]
    assert tconf.get_smoke(arch) == tconf.SMOKES[arch]
    name = tconf.ARCHS[arch].name
    assert tconf.TRAIN_OVERRIDES.get(name) == jconf.TRAIN_OVERRIDES.get(name)


def test_registries_hold_the_reference_archs():
    assert list(tconf.ARCHS) == list(jconf.ARCHS)
    assert list(tconf.SMOKES) == list(jconf.SMOKES)
    assert tconf.DP_MODE == jconf.DP_MODE
    assert tconf.TRAIN_OVERRIDES == jconf.TRAIN_OVERRIDES


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in tconf.ARCHS:
        for shape in tshapes.SHAPES:
            assert (tshapes.applicable(tconf.ARCHS[arch], shape)
                    == jshapes.applicable(jconf.ARCHS[arch], shape))
            assert (tshapes.skip_reason(tconf.ARCHS[arch], shape)
                    == jshapes.skip_reason(jconf.ARCHS[arch], shape))


@pytest.mark.parametrize("arch", NEW)
def test_smoke_config_two_steps_match_reference(arch):
    jspec = dataclasses.replace(JSpec.load(SPEC), arch=arch)
    tspec = dataclasses.replace(TSpec.load(SPEC), arch=arch)
    _, opt, _, jts = j_build(jspec)
    _, topt, _, tts = ttrain.build(tspec, "cpu")
    assert tts.d_local == jts.d_local
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


def test_fsdp_arch_at_full_size_raises():
    """The fsdp storage mode is ported (tests/test_torch_fsdp.py):
    ``make_train_step`` with ``dp_mode="fsdp"`` builds the full-size step
    without allocating anything (one pod: dense and EF-free, each worker
    holding 1/P of the flat params); only an unknown mode raises. A
    full-size fsdp arch's spec does not ask for it: like the reference's
    ``RunSpec``, it builds the dp step (see the test below); its smoke
    config runs in dp too."""
    from repro_torch.core.gs_sgd import make_train_step
    spec = dataclasses.replace(TSpec.load(SPEC), arch="yi-9b", smoke=False)
    ts = make_train_step(spec.arch_config(), spec.mesh_axes(),
                         spec.make_optimizer(), dp_mode="fsdp",
                         spec=spec.exchange, device="cpu")
    P = spec.mesh_axes().dp_size
    assert ts.dp_mode == "fsdp" and ts.sharded and ts.compressor is None
    assert ts.d_local * P == ts.fs.total and ts.comp_groups == ()
    with pytest.raises(ValueError, match="dp_mode"):
        make_train_step(spec.arch_config(), spec.mesh_axes(),
                        spec.make_optimizer(), dp_mode="zero3",
                        spec=spec.exchange, device="cpu")
    assert spec.make_train_step(device="cpu").dp_mode == "dp"
    smoke = dataclasses.replace(spec, smoke=True)
    assert smoke.make_train_step(device="cpu").dp_mode == "dp"


@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-7b",
                                  "llama-3.2-vision-11b"])
def test_fsdp_arch_at_full_size_builds_dp_step(arch):
    """Every full-size arch whose production mode is fsdp builds the dp
    step through its spec, as the reference's ``RunSpec.make_train_step``
    does (the fault F4 of ROADMAP.md raised here). Only the step is
    built: nothing of the full-size state is allocated."""
    assert jconf.DP_MODE[arch] == "fsdp"
    tspec = dataclasses.replace(TSpec.load(SPEC), arch=arch, smoke=False)
    jspec = dataclasses.replace(JSpec.load(SPEC), arch=arch, smoke=False)
    t, j = tspec.make_train_step(device="cpu"), jspec.make_train_step()
    assert t.dp_mode == j.dp_mode == "dp"
    assert t.d_local == j.d_local == tspec.resolve_d()
    assert t.compressor.spec.sizes == j.compressor.spec.sizes
    assert [(c.k, c.sketch.rows, c.sketch.width) for c in t.compressor.parts
            ] == [(c.k, c.sketch.rows, c.sketch.width)
                  for c in j.compressor.parts]


def test_cli_runs_a_new_config_on_cpu(capsys):
    out = ttrain.main(["--spec", SPEC, "--arch", "minicpm-2b", "--device",
                       "cpu", "--steps", "1"])
    assert np.isfinite(out["final_loss"])
