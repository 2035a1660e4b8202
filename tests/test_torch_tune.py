"""Port parity for ``repro_torch.tune``: the search (choice, geometry,
predicted economics, runners-up, skips), the trace calibration, the
``plan@1`` loader shim and the drift watchdog, each held against
``repro.tune`` on the same inputs. The error probe runs the port's encode
and HEAVYMIX recovery on the CPU (their plain versions) and the
reference's jnp ones: the same selected coordinates, so the same error."""

import dataclasses
import json
import math

import pytest

from repro import tune as jt
from repro.api import RunSpec as JSpec
from repro.api import WatchSpec as JWatch
from repro_torch import tune as tt
from repro_torch.api import RunSpec as TSpec
from repro_torch.api import WatchSpec as TWatch

REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's tensors are small: one intra-op thread runs them
    faster, and the test workers share the machine's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel=REL):
    if isinstance(a, dict):
        assert set(a) == set(b), (set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rel)
    elif isinstance(a, float):
        assert math.isclose(a, b, rel_tol=rel, abs_tol=0.0), (a, b)
    else:
        assert a == b


def _plans_equal(t, j):
    _close(t.choice.to_json(), j.choice.to_json())
    _close(t.geometry, j.geometry)
    _close(t.predicted, j.predicted)
    _close(t.alternatives, j.alternatives)
    assert t.skipped == j.skipped
    _close(t.provenance, j.provenance)
    assert t.spec.to_json()["exchange"] == j.spec.to_json()["exchange"]
    assert t.train_argv() == j.train_argv()


SEARCHES = [
    ({"buckets": (1, 4), "bwd_chunks": (1, 2)}, {"p": 8, "d": 1_000_000},
     {}),
    ({"methods": ("gs-sgd", "gtopk", "dense"), "buckets": (1, 4),
      "bwd_chunks": (1, 2), "rows": (3, "log"), "widths": (None, 4096)},
     {"p": 16, "d": 2_000_000, "topology": "hier", "group_size": 4},
     {"budget": 9, "seed": 3, "top": 4}),
    ({"buckets": (1, 2, 8), "bwd_chunks": (1, 4), "shapes": (None, "ring")},
     {"p": 5, "d": 91_648, "link_alpha": 2e-4, "link_beta": 1e-9,
      "microbatch": 2},
     {"max_error": 0.05}),
]


@pytest.mark.parametrize("space_kw,env_kw,kw", SEARCHES,
                         ids=["default", "budget-mixed", "calibrated"])
def test_search_gives_the_reference_plan(space_kw, env_kw, kw):
    t = tt.search(tt.SearchSpace(**space_kw), tt.Env(**env_kw),
                  device="cpu", **kw)
    j = jt.search(jt.SearchSpace(**space_kw), jt.Env(**env_kw), **kw)
    _plans_equal(t, j)
    assert t.provenance["n_evaluated"] >= 1


def test_cost_model_and_validation_match():
    env_t, env_j = tt.Env(p=8, d=1_000_000), jt.Env(p=8, d=1_000_000)
    for cand in ({"buckets": 4, "bwd_chunks": 2}, {"method": "gtopk"},
                 {"method": "sketched-sgd", "shape": "ps"},
                 {"rows": "log", "width": 2048, "k_frac": 0.002}):
        ct = tt.CostModel(env_t, device="cpu").evaluate(
            tt.Candidate(**cand))
        cj = jt.CostModel(env_j).evaluate(jt.Candidate(**cand))
        _close(ct.to_json(), cj.to_json())
    for bad in ({"method": "gtopk", "bwd_chunks": 2},
                {"method": "gtopk", "shape": "ring"}):
        errs = []
        for pkg, env in ((tt, env_t), (jt, env_j)):
            with pytest.raises(ValueError) as e:
                pkg.validate(pkg.Candidate(**bad), env)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    assert tt.probe_gradient(1000, seed=4).tolist() == \
        jt.probe_gradient(1000, seed=4).tolist()


def test_calibration_fit_matches():
    cells = [(4, 7168.0), (8, 7168.0), (4, 13312.0)]
    for kw in ({"alpha": 2e-4, "beta": 3e-9, "t_compute": 0.1},
               {"alpha": 0.0, "beta": 1e-8, "t_compute": 0.05,
                "jitter": 0.05, "seed": 2}):
        doc_t = tt.synthetic_trace(cells=cells, steps=5, **kw)
        doc_j = jt.synthetic_trace(cells=cells, steps=5, **kw)
        assert doc_t == doc_j
        for window in (None, 11):
            _close(tt.fit(doc_t, window=window).to_json(),
                   jt.fit(doc_j, window=window).to_json())
    flat = tt.synthetic_trace(cells=[(4, 7168.0)], alpha=1e-4, beta=1e-9,
                              t_compute=0.1)
    errs = []
    for pkg in (tt, jt):
        with pytest.raises(ValueError) as e:
            pkg.fit(flat)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    env = tt.Env(p=2, d=91_648)
    cal = tt.fit(doc_t)
    assert cal.apply(env).link_alpha == cal.alpha


def test_plan_v1_shim_and_cross_loading(tmp_path):
    env_kw = {"p": 2, "d": 91_648, "t_compute": 0.05}
    space_kw = {"buckets": (2,), "bwd_chunks": (2,), "rows": (3,),
                "widths": (512,), "k_fracs": (0.01,)}
    tplan = tt.search(tt.SearchSpace(**space_kw), tt.Env(**env_kw),
                      top=1, error_probe=False)
    jplan = jt.search(jt.SearchSpace(**space_kw), jt.Env(**env_kw),
                      top=1, error_probe=False)
    v1 = {"schema": "repro.tune/plan@1", "version": 1,
          "env": tt.Env(**env_kw).to_json(),
          "choice": tplan.choice.to_json(),
          "geometry": dict(tplan.geometry),
          "predicted": dict(tplan.predicted), "alternatives": [],
          "skipped": [], "provenance": dict(tplan.provenance)}
    path = tmp_path / "plan_v1.json"
    path.write_text(json.dumps(v1))
    old_t, old_j = tt.TunePlan.load(str(path)), jt.TunePlan.load(str(path))
    assert old_t.spec.exchange == tplan.spec.exchange
    assert old_t.train_argv() == old_j.train_argv() == tplan.train_argv()
    assert old_t.spec.to_json()["exchange"] == old_j.spec.to_json()[
        "exchange"]
    # a plan either package wrote loads in the other
    tplan.save(str(tmp_path / "t.json"))
    jplan.save(str(tmp_path / "j.json"))
    assert jt.TunePlan.load(str(tmp_path / "t.json")).train_argv() == \
        tt.TunePlan.load(str(tmp_path / "j.json")).train_argv()
    shaped = dataclasses.replace(
        tplan, choice=dataclasses.replace(tplan.choice, shape="ring"))
    with pytest.raises(ValueError, match="collective shape"):
        shaped.train_exchange()
    with pytest.raises(ValueError):
        tt.TunePlan.from_json({"schema": "nope"})


def _watch_specs(**watch):
    doc = JSpec(d=1_000_000, steps=20).to_json()
    doc["cluster"] = {**doc["cluster"], "p": 8, "compute_jitter": 0.0}
    doc["watch"] = {**JWatch(enabled=True).to_json(), **watch}
    return TSpec.from_json(doc), JSpec.from_json(doc)


@pytest.mark.parametrize("case", ["congestion", "forced_hot", "clean"])
def test_watchdog_log_matches_the_reference(case):
    if case == "forced_hot":
        specs = _watch_specs(warmup=1, delta=-1.0, threshold=0.0,
                             replan_budget=4)
    else:
        specs = _watch_specs()
    logs, outs = [], []
    for pkg, spec in zip((tt, jt), specs):
        wd = pkg.Watchdog(spec)
        out = []
        for s in range(20):
            t = 0.25 if (case == "congestion" and s >= 8) else 0.11
            if case == "forced_hot":
                t = 0.11 + 0.001 * (s % 3)
            new = wd.on_step({"step": s, "t_step": t, "warmup": s == 0,
                              "p": 8}, now=0.5 * s)
            out.append(None if new is None else new.to_json()["exchange"])
        logs.append(wd.log)
        outs.append(out)
    assert outs[0] == outs[1]
    tlog, jlog = logs
    assert [e["kind"] for e in tlog] == [e["kind"] for e in jlog]
    for a, b in zip(tlog, jlog):
        assert a.get("choice") == b.get("choice")
        for k in ("predicted", "current", "gain"):
            if k in a:
                assert abs(a[k] - b[k]) <= 1e-9, (k, a[k], b[k])
        if "profile" in a:
            _close(a["profile"], b["profile"])
    kinds = [e["kind"] for e in tlog]
    if case == "clean":
        assert kinds == []
    else:
        assert "drift.detected" in kinds
        assert len(kinds) == 2 * kinds.count("drift.detected")


def test_watchdog_refuses_a_non_replayable_compressor():
    spec = TSpec(d=1 << 16, watch=TWatch(enabled=True))
    spec = dataclasses.replace(spec, exchange=dataclasses.replace(
        spec.exchange, compressor="topk"))
    with pytest.raises(ValueError, match="not replayable"):
        tt.Watchdog(spec)
