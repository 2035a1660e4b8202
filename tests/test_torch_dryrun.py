"""The dry-run (``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.dryrun``) on small meshes.

The reference lowers and compiles its train cell (``build_train_cell``)
for the qwen3-4b (dp) and yi-9b (fsdp) smoke configs on CPU meshes of
(2, 2) ('data', 'model') and (2, 2, 2) ('pod', 'data', 'model'), in a
subprocess with 8 host devices, with ``SHAPES["train_4k"]`` set to seq
64 and global batch 8 and the smoke configs' ``TRAIN_OVERRIDES`` row to
k 512, rows 5, width 4096 *in that subprocess* (the reference's files
are not touched). The port runs the same cells on the meta device, one
rank of a fake world of 4 or 8. Held:

- ``argument_bytes`` equal to XLA's ``memory_analysis().
  argument_size_in_bytes``;
- the exchange's collectives over the data and pod groups (the summed
  sketch and the second round's k values: every all-reduce there whose
  result is not a scalar) equal to the reference's HLO, array by array,
  byte for byte;
- the model axis at a one-cycle config (qwen3-4b smoke with one layer,
  seq 64 under one attention and one loss chunk, one microbatch slice),
  where each HLO site runs once a step: the elements of the all-reduces
  and of the reduce-scatters over the model group within
  MODEL_AXIS_RTOL of the reference's (elements: the CPU compile promotes
  the reference's bf16 all-reduces to f32); the all-gathers are the
  port's and one more, the reference's re-gather of the cycle's
  replicated segment in its recompute (the port gathers once a step).
  The port counts what it executes, the recompute of the checkpointed
  cycle and loss chunk included; XLA's remat keeps those as sites of
  their own;
- the FLOPs within FLOP_RATIO of XLA's ``cost_analysis``. XLA counts a
  loop body once (a ``lax.scan`` of 10 matmuls reports one), and counts
  elementwise ops; ``FlopCounterMode`` counts only matmuls, attention and
  convolutions, every executed one. So the ratio is stated as a range,
  written before the first reading.

Also: the ``per_kind`` summary follows the reference's ``_WIRE_FACTOR``;
the CLI's meta run writes its JSON with the reference's keys (and
``counted: "executed"``); a cell that fails prints ``[FAIL]`` and the
run exits non-zero.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SMOKES
from repro_torch.configs.shapes import ShapeCase
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KW = dict(k=512, rows=5, width=4096)
CASE = ShapeCase("train_4k", "train", 64, 8)
MESHES = {"single": ((2, 2), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = [(a, m) for a in ("qwen3-4b", "yi-9b") for m in ("single", "multi")]
# stated before the first reading (module docstring)
FLOP_RATIO = (0.5, 4.0)        # port / XLA
MODEL_AXIS_RTOL = 0.05

_REF_SCRIPT = r"""
import os, sys, json, re, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
jax.devices()
from jax.sharding import Mesh
from repro.configs import SMOKES, DP_MODE, TRAIN_OVERRIDES
from repro.configs.shapes import SHAPES, ShapeCase
from repro.launch import dryrun as ref
from repro.launch.mesh import mesh_axes_of

cells = json.loads(sys.argv[1])
kw = json.loads(sys.argv[2])
SHAPES["train_4k"] = ShapeCase("train_4k", "train", 64, 8)
MESHES = {"single": ((2, 2), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}

def groups(line):
    m = re.search(r"replica_groups=\{(\{[0-9,]+\}(?:,\{[0-9,]+\})*)\}", line)
    if m:
        return [[int(x) for x in g.split(",")]
                for g in re.findall(r"\{([0-9,]+)\}", m.group(1))]
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\]"
                  r"(?:T\(([0-9,]+)\))?", line)
    if m:
        a, b = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(x) for x in m.group(4).split(",")])
        return ids.reshape(a, b).tolist()
    return None

def axes_of(group, devs, names):
    coords = [np.argwhere(devs == i)[0] for i in group]
    return [n for j, n in enumerate(names)
            if len({int(c[j]) for c in coords}) > 1]

out = {}
for arch, mesh_kind, layers in cells:
    cfg = SMOKES[arch]
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    TRAIN_OVERRIDES[cfg.name] = {"compressor_kw": kw}
    shape, names = MESHES[mesh_kind]
    devs = np.arange(int(np.prod(shape))).reshape(shape)
    mesh = Mesh(np.array(jax.devices()[:devs.size]).reshape(shape), names)
    ma = mesh_axes_of(mesh)
    fn, args = ref.build_train_cell(cfg, mesh, ma, DP_MODE[arch])
    with jax.set_mesh(mesh):
        compiled = fn.lower(*args).compile()
    mem = compiled.memory_analysis()
    colls = []
    for line in compiled.as_text().splitlines():
        m = ref._COLL_RE.search(line)
        if not m:
            continue
        g = groups(line)
        ax = axes_of(g[0], devs, names) if g else None
        arrays = [ref._type_bytes(f"{dt}[{dims}]") for dt, dims in
                  ref._SHAPE_RE.findall(m.group("ty"))]
        numels = [int(np.prod([int(x) for x in dims.split(",") if x]))
                  for dt, dims in ref._SHAPE_RE.findall(m.group("ty"))]
        colls.append({"kind": m.group("op"), "axes": ax, "arrays": arrays,
                      "numels": numels})
    out[f"{arch}/{mesh_kind}/{layers}"] = {
        "argument_bytes": int(mem.argument_size_in_bytes),
        "flops": float(compiled.cost_analysis().get("flops", 0.0)),
        "collectives": colls}
print(json.dumps(out))
"""

REF_CELLS = [(a, m, 0) for a, m in CELLS] + [("qwen3-4b", "single", 1)]


@pytest.fixture(scope="module")
def ref() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                          json.dumps(REF_CELLS), json.dumps(KW)], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def port_cell(arch: str, mesh_kind: str, layers: int = 0) -> dict:
    import dataclasses
    cfg = SMOKES[arch]
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    records = []
    orig = dryrun.collectives_of

    def keep(recs):          # the raw records beside the summary
        records.extend(recs)
        return orig(recs)

    dryrun.collectives_of = keep
    try:
        r = dryrun.run_cell(arch, "train_4k", mesh_kind, device="meta",
                            save=False, cfg=cfg, case=CASE,
                            mesh_shape=MESHES[mesh_kind],
                            overrides={"compressor_kw": KW})
    finally:
        dryrun.collectives_of = orig
    r["records"] = records
    return r


@pytest.fixture(scope="module")
def port() -> dict:
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {f"{a}/{m}/{l}": port_cell(a, m, l) for a, m, l in REF_CELLS}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.set_num_threads(n)


def _exchange_ref(colls) -> list:
    out = []
    for c in colls:
        if c["kind"] == "all-reduce" and c["axes"] and "model" not in \
                c["axes"]:
            out += [b for b, n in zip(c["arrays"], c["numels"]) if n > 1]
    return sorted(out)


def _exchange_port(records) -> list:
    return sorted(r["result_bytes"] for r in records
                  if r["kind"] == "all-reduce" and "model" not in r["axes"]
                  and math.prod(r["shape"]) > 1)


@pytest.mark.parametrize("arch,mesh_kind", CELLS)
def test_argument_bytes_equal_reference(ref, port, arch, mesh_kind):
    key = f"{arch}/{mesh_kind}/0"
    assert port[key]["memory"]["argument_bytes"] == \
        ref[key]["argument_bytes"]


@pytest.mark.parametrize("arch,mesh_kind", CELLS)
def test_exchange_collectives_equal_reference(ref, port, arch, mesh_kind):
    key = f"{arch}/{mesh_kind}/0"
    want = _exchange_ref(ref[key]["collectives"])
    got = _exchange_port(port[key]["records"])
    assert got == want, (got, want)
    if dryrun.DP_MODE[arch] == "dp" or mesh_kind == "multi":
        # the summed sketch and the second round's k values
        assert sorted(got) == sorted([KW["rows"] * KW["width"] * 4,
                                      KW["k"] * 4]), got


def _model_elems(items, kind: str, port: bool) -> int:
    """Elements of the ``kind`` collectives over the model group alone."""
    if port:
        return sum(math.prod(r["shape"]) for r in items
                   if r["kind"] == kind and r["axes"] == ("model",))
    return sum(sum(c["numels"]) for c in items
               if c["kind"] == kind and c["axes"] == ["model"])


@pytest.mark.parametrize("kind", ["all-reduce", "reduce-scatter"])
def test_model_axis_elements_at_one_cycle(ref, port, kind):
    """Elements, not bytes: the CPU compile promotes the reference's bf16
    all-reduces (the activations' psums) to f32, so its HLO shows twice
    the bytes the program sums (and a TPU moves)."""
    key = "qwen3-4b/single/1"
    want = _model_elems(ref[key]["collectives"], kind, port=False)
    got = _model_elems(port[key]["records"], kind, port=True)
    assert want > 0
    assert abs(got - want) <= MODEL_AXIS_RTOL * want, (got, want)


def test_model_axis_all_gather_at_one_cycle(ref, port):
    """The reference gathers a cycle's replicated segment inside the
    checkpointed cycle, so once more in its recompute; the port gathers
    every segment once a step, before the forward. So the reference's
    all-gathers over the model group are the port's and one more of the
    cycle's replicated segment."""
    key = "qwen3-4b/single/1"
    recs = port[key]["records"]
    cyc = [r for r in recs if r["kind"] == "all-gather"
           and r["axes"] == ("model",) and len(r["shape"]) == 3]
    assert len(cyc) == 1                       # (tp, n_cycles, f_cyc_r)
    want = _model_elems(ref[key]["collectives"], "all-gather", port=False)
    got = _model_elems(recs, "all-gather", port=True)
    assert want == got + math.prod(cyc[0]["shape"]), (got, want)


@pytest.mark.parametrize("arch,mesh_kind", CELLS)
def test_flops_within_stated_ratio(ref, port, arch, mesh_kind):
    key = f"{arch}/{mesh_kind}/0"
    ratio = port[key]["cost"]["flops"] / ref[key]["flops"]
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], ratio


def test_per_kind_follows_reference_wire_factor():
    recs = [{"kind": "all-reduce", "axes": ("data",), "group": 16,
             "result_bytes": 1600, "shape": (400,), "dtype": "float32"},
            {"kind": "all-gather", "axes": ("pod", "data"), "group": 32,
             "result_bytes": 3200, "shape": (32, 25), "dtype": "float32"},
            {"kind": "reduce-scatter", "axes": ("model",), "group": 16,
             "result_bytes": 100, "shape": (25,), "dtype": "float32"}]
    c = dryrun.collectives_of(recs)
    assert c["per_kind"]["all-reduce"]["wire_bytes"] == 1600 * 2 * 15 / 16
    assert c["per_kind"]["all-gather"]["wire_bytes"] == 3200 * 31 / 32
    assert c["per_kind"]["reduce-scatter"]["wire_bytes"] == 100 * 15
    assert c["pod_crossing_wire_bytes"] == 3200 * 31 / 32
    assert c["total_wire_bytes"] == 3000 + 3100 + 1500
    assert c["per_axis"]["pod+data"]["all-gather"]["count"] == 1


def _cli(args: list, tmp) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", _CLI_SCRIPT, str(tmp)]
                          + args, env=env, capture_output=True, text=True,
                          timeout=600, cwd=ROOT)


# the CLI over a smoke config (the production arch's config swapped for
# its smoke, the shapes cut) with its files under a temporary directory
_CLI_SCRIPT = r"""
import sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import ARCHS, SMOKES, shapes
from repro_torch.launch import dryrun
dryrun.OUT_DIR = sys.argv[1]
for a in list(ARCHS):
    ARCHS[a] = SMOKES[a]
shapes.SHAPES.update(
    train_4k=shapes.ShapeCase("train_4k", "train", 32, 32),
    prefill_32k=shapes.ShapeCase("prefill_32k", "prefill", 32, 32),
    decode_32k=shapes.ShapeCase("decode_32k", "decode", 32, 32))
dryrun.PRODUCTION.update({False: ((2, 2), ("data", "model")),
                          True: ((2, 2, 2), ("pod", "data", "model"))})
args = sys.argv[2:]
if "--fail-train" in args:          # a cell whose build raises
    args.remove("--fail-train")

    def broken(*a, **k):
        raise RuntimeError("train cell broken on purpose")

    dryrun.build_train_cell = broken
sys.argv = ["dryrun"] + args
dryrun.main()
"""


def test_cli_meta_writes_reference_schema(tmp_path):
    res = _cli(["--arch", "qwen3-4b", "--mesh", "single", "--device",
                "meta"], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("[ OK ]") == 3, res.stdout
    assert "[SKIP] qwen3-4b x long_500k x single" in res.stdout
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        r = json.loads((tmp_path / f"qwen3-4b__{shape}__single.json")
                       .read_text())
        assert set(r) >= {"arch", "shape", "mesh", "status", "dp_mode",
                          "n_devices", "memory", "cost", "collectives",
                          "counted", "build_seconds"}
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "peak_bytes",
                                    "alias_bytes"}
        assert r["memory"]["peak_bytes"] is None      # meta: no peak
        assert r["counted"] == "executed" and r["n_devices"] == 4
        assert set(r["collectives"]) >= {"per_kind", "total_wire_bytes",
                                         "pod_crossing_wire_bytes"}
        assert r["cost"]["flops"] > 0


def test_cli_failing_cell_prints_fail_and_exits_nonzero(tmp_path):
    res = _cli(["--arch", "qwen3-4b", "--mesh", "single", "--device",
                "meta", "--fail-train"], tmp_path)
    assert res.returncode != 0
    assert "[FAIL] qwen3-4b x train_4k x single" in res.stdout
    assert "broken on purpose" in res.stdout        # its traceback
    assert res.stdout.count("[ OK ]") == 2          # the others still ran
