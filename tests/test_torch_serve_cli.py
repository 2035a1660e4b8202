"""Port parity: the serve surface of the spec (``ServeSpec``, its flags and
checks), the serve driver (``launch/serve.py``) and the load-test audit
(``bench/serve_load.py``) on the CPU, the engine's ``serve.*`` trace
events, and the driver's refusal to fall back to the CPU.

Spec JSON is held equal across the packages; the driver runs the port's
own seeded init (its tokens differ from the reference CLI's, whose init
is ``jax.random``), so its runs are checked for shape and the load
test's four acceptance checks.
"""

import dataclasses
import json

import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import obs
from repro_torch.bench import serve_load
from repro_torch.configs import SMOKES
from repro_torch.launch import serve as tserve
from repro_torch.models.flatten import init_flat_params, make_flat_spec
from repro_torch.serve import Request, ServeEngine


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SERVE_KW = dict(batch=7, block_size=16, max_len=64, prompt_len=20, gen=12,
                paged=False, policy="static", kv_blocks=33, deadline=2.5,
                rate=10.0, n_requests=9, stop_token=3, replicas=2,
                kv_frac=0.25)


def test_servespec_json_roundtrip_across_packages(tmp_path):
    """A spec the reference writes loads in the port and dumps the same
    JSON, and the other way round."""
    jbase = japi.RunSpec(smoke=True, arch="zamba2-2.7b", seed=5)
    jspec = dataclasses.replace(
        jbase, serve=dataclasses.replace(jbase.serve, **SERVE_KW),
        cluster=dataclasses.replace(jbase.cluster, mem_gb=3.5))
    jspec.validate()
    path = tmp_path / "ref.json"
    jspec.save(str(path))
    tspec = tapi.RunSpec.load(str(path))
    tspec.validate()
    assert tspec.to_json() == jspec.to_json()
    assert tspec.serve == tapi.ServeSpec(**SERVE_KW)
    tspec.save(str(path))
    assert japi.RunSpec.load(str(path)) == jspec
    # a reference spec without a serve block loads with the defaults
    doc = japi.RunSpec(smoke=True).to_json()
    del doc["serve"]
    assert tapi.RunSpec.from_json(doc).serve == tapi.ServeSpec()
    assert tapi.RunSpec().to_json()["serve"] == \
        japi.RunSpec().to_json()["serve"]


def test_serve_flags_fold_into_spec():
    argv = ["--batch", "9", "--prompt-len", "17", "--gen", "5",
            "--no-paged", "--policy", "static", "--kv-frac", "0.25",
            "--max-len", "none", "--deadline", "1.5", "--mem-gb", "2"]
    t = tapi.apply_args(tapi.RunSpec(smoke=True),
                        tapi.build_parser("serve").parse_args(argv), "serve")
    j = japi.apply_args(japi.RunSpec(smoke=True),
                        japi.build_parser("serve").parse_args(argv), "serve")
    assert t.to_json() == j.to_json()
    sv = t.serve
    assert (sv.batch, sv.prompt_len, sv.gen) == (9, 17, 5)
    assert sv.paged is False and sv.policy == "static"
    assert t.cluster.mem_gb == 2.0
    assert tapi.RunSpec.from_json(t.to_json()) == t
    # the train surface grows no serve-only flag, and keeps its --batch
    tp = tapi.build_parser("train")
    with pytest.raises(SystemExit):
        tp.parse_args(["--prompt-len", "17"])
    assert tapi.apply_args(tapi.RunSpec(), tp.parse_args(["--batch", "3"]),
                           "train").batch == 3
    flags = sorted(a.option_strings[0]
                   for a in tapi.build_parser("serve")._actions[1:])
    jflags = sorted(a.option_strings[0]
                    for a in japi.build_parser("serve")._actions[1:])
    assert flags == jflags


@pytest.mark.parametrize("bad", [
    {"batch": 0}, {"gen": 0}, {"max_len": 0}, {"kv_blocks": 0},
    {"max_len": 8, "prompt_len": 8}, {"policy": "fifo"}, {"kv_frac": 0.0},
    {"kv_frac": 1.5}, {"rate": float("inf")}, {"deadline": 0.0}])
def test_servespec_validation_matches(bad):
    with pytest.raises(ValueError) as te:
        tapi.ServeSpec(**bad).validate()
    with pytest.raises(ValueError) as je:
        japi.ServeSpec(**bad).validate()
    assert str(te.value) == str(je.value)


def test_resolved_max_len_rounds_to_blocks():
    for kw in (dict(prompt_len=10, gen=5, block_size=8),
               dict(prompt_len=10, gen=6, block_size=8, max_len=24),
               dict(prompt_len=3, gen=1, block_size=16)):
        assert tapi.ServeSpec(**kw).resolved_max_len() == \
            japi.ServeSpec(**kw).resolved_max_len()
    assert tapi.ServeSpec(prompt_len=10, gen=5,
                          block_size=8).resolved_max_len() == 16


def test_serve_demo_on_cpu(tmp_path, capsys):
    dump = tmp_path / "spec.json"
    out = tserve.main(["--smoke", "--batch", "2", "--prompt-len", "6",
                       "--gen", "4", "--device", "cpu", "--dump-spec",
                       str(dump)])
    text = capsys.readouterr().out
    assert "steady" in text and "cold" in text and "device=cpu" in text
    assert len(out["tokens"]) == 2 and all(len(t) == 4
                                           for t in out["tokens"])
    assert out["tok_per_s"] > 0 and out["tok_per_s_cold"] > 0
    again = tserve.main(["--spec", str(dump), "--device", "cpu"])
    assert again["tokens"] == out["tokens"]       # seeded, deterministic


def test_serve_load_test_on_cpu(tmp_path):
    path = tmp_path / "serve.json"
    report = tserve.main(["--smoke", "--load-test", "--requests", "6",
                          "--rate", "100", "--batch", "3", "--gen", "6",
                          "--prompt-len", "8", "--json", str(path),
                          "--device", "cpu"])
    assert json.load(open(path)) == json.loads(json.dumps(report))
    assert report["provenance"]["backend"] == "cpu"
    assert report["tokens_match_static"]
    assert report["continuous"]["ttft"]["count"] == 6
    assert report["wall"]["tok_per_s_cold"] > 0


def test_bench_serve_load_on_cpu(tmp_path, capsys):
    out = tmp_path / "sub" / "BENCH_serve.json"
    assert serve_load.main(["--fast", "--requests", "8", "--device", "cpu",
                            "--out", str(out)]) == 0
    doc = json.load(open(out))
    assert doc["schema"] == serve_load.SCHEMA
    assert all(doc["checks"].values()) and len(doc["checks"]) == 4
    assert "all checks ok" in capsys.readouterr().out


def test_serve_refuses_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke", "--gen", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build(tapi.RunSpec(smoke=True))


def test_engine_trace_events():
    """The engine's serve.* instants and spans through the port's tracer:
    admit, prefill, decode, finish; a drop; an eviction under a tight
    pool."""
    cfg = SMOKES["qwen3-4b"]
    fs = make_flat_spec(cfg, 1)
    segs = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, fs)
    base = tapi.RunSpec(smoke=True)
    spec = dataclasses.replace(base, serve=dataclasses.replace(
        base.serve, batch=2, block_size=4, max_len=12, prompt_len=7, gen=6,
        kv_blocks=5))
    tr = obs.Tracer()
    with tr.activate():
        eng = ServeEngine(cfg, fs, segs, spec)
        for rid in range(2):
            eng.submit(Request(rid=rid, prompt=tuple(range(1, 8)),
                               max_new=5))
        eng.submit(Request(rid=2, prompt=(1,) * 30, max_new=2))
        done = {c.rid: c for c in eng.run()}
    doc = tr.to_chrome(source="serve")
    assert obs.validate(doc) > 0
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] != "M"}
    assert {"serve.admit", "serve.prefill", "serve.decode", "serve.finish",
            "serve.drop", "serve.evict"} <= names
    assert done[2].reason == "too_long"
    assert any(c.replays for c in done.values())
