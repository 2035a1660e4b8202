"""Port parity: the dense architectures' configs (yi-9b, minicpm-2b,
starcoder2-3b) and ``configs/shapes.py``.

The registry rows must equal the reference's field for field. Two gs-SGD
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


@pytest.mark.parametrize("arch", NEW + ("qwen3-4b",))
def test_registry_rows_equal_reference(arch):
    assert (dataclasses.asdict(tconf.ARCHS[arch])
            == dataclasses.asdict(jconf.ARCHS[arch]))
    assert (dataclasses.asdict(tconf.SMOKES[arch])
            == dataclasses.asdict(jconf.SMOKES[arch]))
    assert tconf.DP_MODE[arch] == jconf.DP_MODE[arch]
    assert tconf.get(arch) == tconf.ARCHS[arch]
    assert tconf.get_smoke(arch) == tconf.SMOKES[arch]


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
    """yi-9b's production mode is fsdp, which the port does not run: the
    spec's train step raises before allocating anything; its smoke config
    runs in dp."""
    spec = dataclasses.replace(TSpec.load(SPEC), arch="yi-9b", smoke=False)
    with pytest.raises(NotImplementedError, match="fsdp"):
        spec.make_train_step(device="cpu")
    smoke = dataclasses.replace(spec, smoke=True)
    assert smoke.make_train_step(device="cpu").dp_mode == "dp"


def test_cli_runs_a_new_config_on_cpu(capsys):
    out = ttrain.main(["--spec", SPEC, "--arch", "minicpm-2b", "--device",
                       "cpu", "--steps", "1"])
    assert np.isfinite(out["final_loss"])
