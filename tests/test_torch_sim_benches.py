"""Port parity: the host-only simulator benches of ``repro_torch.bench``
(``drift_audit``, ``sim_sweep``, ``tune_sweep`` with ``--fast``;
``sim_scale`` at small P) against ``benchmarks/``.

Each pair runs once (module fixtures; the reference's output directory
is pointed at ``tmp_path``). The port's document equals the reference's
apart from the provenance and the host's wall-clock fields: the
simulator's clock, its events and the tuner's costs are the same model
in both packages.
"""

import json

import pytest

from benchmarks import drift_audit as jda
from benchmarks import sim_scale as jss
from benchmarks import sim_sweep as jsw
from benchmarks import tune_sweep as jts
from repro_torch.bench import drift_audit as tda
from repro_torch.bench import sim_scale as tss
from repro_torch.bench import sim_sweep as tsw
from repro_torch.bench import tune_sweep as tts

WALL = ("provenance", "wall_s", "events_per_s", "worker_steps_per_s",
        "wall_speedup")
SCALE_ARGV = ["--speedup-p", "16", "--p", "64", "--speedup-floor", "0"]


def strip(doc, keys=WALL):
    if isinstance(doc, dict):
        return {k: strip(v, keys) for k, v in doc.items() if k not in keys}
    if isinstance(doc, list):
        return [strip(v, keys) for v in doc]
    return doc


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sim_benches")
    mp = pytest.MonkeyPatch()
    for mod in (jsw, jss, jts):
        mp.setattr(mod, "OUT", str(tmp / "j"))
    try:
        ref = {"sweep": jsw.main(["--fast"]), "tune": jts.main(["--fast"]),
               "scale": jss.main(SCALE_ARGV),
               "drift_rc": jda.main(["--fast", "--out",
                                     str(tmp / "j_drift.json")])}
    finally:
        mp.undo()
    out = str(tmp / "t")
    got = {"sweep": tsw.main(["--fast", "--out", out]),
           "tune": tts.main(["--fast", "--out", out]),
           "scale": tss.main(SCALE_ARGV + ["--out", out]),
           "drift_rc": tda.main(["--fast", "--out",
                                 str(tmp / "t_drift.json")])}
    for d, name in ((ref, "j_drift"), (got, "t_drift")):
        with open(tmp / f"{name}.json") as f:
            d["drift"] = json.load(f)
    return ref, got, tmp


@pytest.mark.parametrize("bench", ["drift", "sweep", "tune", "scale"])
def test_document_equals_the_reference(docs, bench):
    ref, got, _ = docs
    assert strip(got[bench]) == strip(ref[bench])


def test_outputs_and_checks(docs):
    ref, got, tmp = docs
    assert got["drift_rc"] == ref["drift_rc"] == 0
    assert got["drift"]["ok"] and all(got["drift"]["checks"].values())
    for name in ("BENCH_sim.json", "BENCH_tune.json",
                 "BENCH_simscale.json"):
        assert (tmp / "t" / name).exists()
    assert got["tune"]["checks"]["hier_maxp_saving_frac"] > 0
    assert got["scale"]["speedup"]["floor"] == 0.0


def test_drift_audit_exits_1_on_a_failed_check(tmp_path, monkeypatch):
    """A watchdog that never re-plans fails ``replanned`` and
    ``makespan_improved``: the audit exits 1."""
    monkeypatch.setattr(tda, "SimWatcher", lambda spec: None)
    rc = tda.main(["--fast", "--out", str(tmp_path / "d.json")])
    with open(tmp_path / "d.json") as f:
        doc = json.load(f)
    assert rc == 1 and not doc["ok"]
    assert not doc["checks"]["replanned"]
