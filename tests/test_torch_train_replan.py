"""The port's train driver's re-planning loop on the CPU at the smoke
config: ``--auto-tune`` bit-equal to the plan's manual flags, the tuner
CLI's ``--calibrate`` against ``repro.launch.tune`` on the same trace@2
files, the drift watchdog forced hot (detect, decide, rebuild, rebase the
error feedback), and ``resolve_spec``."""

import dataclasses

import pytest

from repro.launch.tune import main as j_tune
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import main as t_train
from repro_torch.launch.tune import main as t_tune

CPU = ["--device", "cpu"]
HOT = ["--watch", "--drift-warmup", "1", "--drift-delta", "-1",
       "--drift-threshold", "0", "--replan-budget", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's tensors are small: one intra-op thread runs them
    faster, and the test workers share the machine's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tune_cli_calibrates_like_the_reference(tmp_path):
    """Three trace@2 captures of the smoke spec at buckets 2, buckets 1 and
    buckets 1 at width 1,024 (rounds and bytes both vary, so the Eq. 1 fit
    is identifiable; the records as ``--json`` writes them, warmup tags
    included), then each package's tuner CLI on them: the same calibration
    and the same plan."""
    import json

    import numpy as np

    from repro_torch import obs
    tmp = tmp_path
    paths = []
    rng = np.random.default_rng(0)
    for name, rounds, nbytes in (("b2", 8, 7168.0), ("b1", 4, 7168.0),
                                 ("b1w", 4, 13312.0)):
        recs = [{"step": s, "t_step": 0.05 + rounds * 1e-4 + nbytes * 2e-9
                 + 1e-4 * float(rng.random()), "loss": 5.5, "rounds": rounds,
                 "bytes": nbytes, "warmup": s == 0} for s in range(4)]
        paths.append(str(tmp / f"{name}.json"))
        obs.dump(obs.trace2_doc(model={"p": 2}, records=recs), paths[-1])
    with open(paths[0]) as f:
        assert json.load(f)["schema"] == "repro.tune/trace@2"
    env = ["--arch", "qwen3-4b", "--smoke", "--p", "2", "--calibrate",
           *paths, "--buckets", "1", "2", "--bwd-chunks", "1", "2",
           "--no-error-probe"]
    t = t_tune(env + CPU + ["--out", str(tmp / "t_plan.json")])
    j = j_tune(env + ["--out", str(tmp / "j_plan.json")])
    assert t.spec.cluster.to_json() == j.spec.cluster.to_json()
    assert t.choice.to_json() == j.choice.to_json()
    assert t.train_argv() == j.train_argv()
    for k, v in j.predicted.items():
        assert t.predicted[k] == pytest.approx(v, rel=1e-12)
    assert t.provenance["host"]["schema"] == "repro.obs/provenance@1"


def test_auto_tune_is_bit_equal_to_the_manual_flags(tmp_path):
    from repro_torch.tune import Env, SearchSpace, search
    d = ttrain.RunSpec(arch="qwen3-4b", smoke=True).resolve_d()
    plan = search(SearchSpace(buckets=(4,), bwd_chunks=(2,), rows=(3,),
                              widths=(1024,), k_fracs=(0.01,)),
                  Env(p=2, d=d, t_compute=0.05), top=1, seed=0,
                  error_probe=False)
    assert plan.train_exchange().bwd_chunks == 2
    path = str(tmp_path / "plan.json")
    plan.save(path)
    common = ["--smoke", "--workers", "2", "--steps", "2", "--batch", "4",
              "--seq", "16", "--log-every", "5"] + CPU
    auto = t_train(common + ["--auto-tune", path])["history"]
    manual = t_train(common + plan.train_argv())["history"]
    assert auto == manual   # bit-exact, not approx


def test_watch_forced_hot_detects_and_decides():
    out = t_train(["--smoke", "--workers", "2", "--steps", "4", "--batch",
                   "4", "--seq", "16", "--log-every", "5"] + CPU + HOT)
    kinds = [e["kind"] for e in out["watch"]]
    assert "drift.detected" in kinds
    assert len(kinds) == 2 * kinds.count("drift.detected")
    for e in out["watch"]:
        if e["kind"] == "watch.replan":
            assert e["gain"] >= 0.01


def test_a_replan_rebuilds_the_step_and_resets_the_residual(capsys):
    """A heavy sketch (20 rows of 2^16, one bucket) re-plans to the
    default geometry: the driver rebuilds the step at the next boundary,
    resets the error feedback (its layout changed) and trains on."""
    out = t_train(["--smoke", "--workers", "2", "--steps", "5", "--batch",
                   "4", "--seq", "16", "--rows", "20", "--width", "65536",
                   "--log-every", "5"] + CPU + HOT)
    said = capsys.readouterr().out
    replans = [e for e in out["watch"] if e["kind"] == "watch.replan"]
    assert replans and all(e["gain"] >= 0.01 for e in replans)
    assert "error-feedback reset" in said
    assert len(out["history"]) == 5
    assert all(x == x for x in out["history"])   # finite, not NaN
    ef = out["state"]["ef"]
    assert isinstance(ef, tuple) and ef[0].shape[0] == 2


def test_drive_rebases_the_residual_by_layout():
    import torch

    from repro_torch.api import ExchangeSpec, RunSpec
    spec = RunSpec.load("examples/specs/qwen3_smoke.json")
    ts = spec.make_train_step(device="cpu")
    state = ts.init_state(spec.make_optimizer(),
                          torch.Generator().manual_seed(0))
    state["ef"] = tuple(torch.ones_like(e) for e in state["ef"])
    kept, same = ttrain.rebase_ef(state, ts)
    assert same and kept is state
    other = dataclasses.replace(spec, exchange=ExchangeSpec(buckets=4))
    reset, same = ttrain.rebase_ef(state, other.make_train_step(device="cpu"))
    assert not same and len(reset["ef"]) == 4
    assert all(float(e.abs().sum()) == 0.0 for e in reset["ef"])
    assert ttrain.state_bytes(ttrain.clone_state(state)) == \
        ttrain.state_bytes(state)


def test_resolve_spec_accepts_trace_and_watch():
    import argparse

    from repro_torch import api
    ap = argparse.ArgumentParser()
    api.add_spec_args(ap, "train")
    for flag in ("--spec", "--auto-tune"):
        ap.add_argument(flag, default=None,
                        dest=flag[2:].replace("-", "_"))
    args = ap.parse_args(["--trace", "t.json", *HOT])
    spec = ttrain.resolve_spec(args)
    assert spec.trace == "t.json" and spec.watch.enabled
    assert spec.watch.warmup == 1 and spec.watch.replan_budget == 4
