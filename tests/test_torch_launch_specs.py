"""Port parity: the process mesh's specs (``repro_torch.launch.specs``,
``launch.mesh``, ``models.common.abstract_params`` / ``pspec_tree``)
against the JAX package's.

- ``local_of`` against the reference's ``NamedSharding``: in a
  subprocess with 8 virtual host devices (as tests/test_shard_map_mesh.py
  runs), on a (2, 2, 2) ('pod', 'data', 'model') mesh, seeded global
  arrays are placed with ``jax.device_put`` (no compile) by the
  reference's specs for params, state (AdamW, with EF), batch (a
  divisible global batch and one that is not: replicated) and cache
  (qwen3-4b, rwkv6-7b and zamba2-2.7b smoke: KV, RWKV and Mamba states),
  in 'dp' and 'fsdp' at tp = 2. Each device's shard must equal
  ``local_of`` at that device's mesh coordinates, bit for bit, the
  global shapes and partitions equal the reference's, and ``global_of``
  of every process's slice must give the global array back.
- ``mesh_axes_of(make_production_mesh(...))`` on a fake process group of
  256 and 512 ranks (a subprocess: the default group is process-global)
  has the fields of the reference's ``mesh_axes_of`` fed the same axis
  names and device shape.
- ``pspec_tree`` and ``abstract_params`` (meta tensors) equal the
  reference's ``pspec_tree`` and ``param_specs(...)`` local shapes for
  all ten archs at tp = 16.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get as j_get
from repro.launch.mesh import mesh_axes_of as j_mesh_axes_of
from repro.models.common import param_specs as j_param_specs
from repro.models.common import pspec_tree as j_pspec_tree
from repro_torch.configs import get as t_get
from repro_torch.models.common import abstract_params, pspec_tree, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SPECS_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.core.gs_sgd import local_seg_shapes as j_local_seg_shapes
from repro.launch import specs as jsp
from repro.launch.mesh import mesh_axes_of
from repro.models.flatten import make_flat_spec as j_flat_spec
from repro.optim import make as j_opt
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.core.gs_sgd import MeshAxes, local_seg_shapes
from repro_torch.launch import specs as tsp
from repro_torch.models.flatten import make_flat_spec
from repro_torch.optim import make as t_opt

torch.set_num_threads(1)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
jma = mesh_axes_of(mesh)
tma = MeshAxes(tp=2, data=2, pod=2, tp_axis="model", data_axis="data",
               pod_axis="pod")
names = mesh.axis_names
where = {}
for idx in np.ndindex(mesh.devices.shape):
    where[mesh.devices[idx].id] = dict(zip(names, (int(i) for i in idx)))
rng = np.random.default_rng(0)
NP = {torch.float32: np.float32, torch.int32: np.int32,
      torch.bfloat16: np.float32}


def entries(pspec, ndim):
    out = []
    for e in tuple(pspec) + (None,) * (ndim - len(tuple(pspec))):
        out.append([] if e is None else [e] if isinstance(e, str)
                   else list(e))
    return out


def leaves(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], path + (k,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, path + (i,))
        return out
    return [(path, tree)]


def check(tag, jspecs, tspecs):
    bad, n = [], 0
    jl, tl = leaves(jspecs), leaves(tspecs)
    if [p for p, _ in jl] != [p for p, _ in tl]:
        return 0, [f"{tag}: leaf paths differ"]
    for (path, js), (_, ts) in zip(jl, tl):
        name = f"{tag}{list(path)}"
        if tuple(js.shape) != ts.shape:
            bad.append(f"{name}: shape {ts.shape} != {tuple(js.shape)}")
            continue
        if entries(js.sharding.spec, len(js.shape)) != [
                list(a) for a in ts.dims()]:
            bad.append(f"{name}: pspec {ts.pspec} != {js.sharding.spec}")
            continue
        g = rng.standard_normal(ts.shape).astype(NP[ts.dtype]) \
            if ts.shape else np.asarray(rng.standard_normal(),
                                        NP[ts.dtype])
        if ts.dtype == torch.int32:
            g = (g * 1000).astype(np.int32)
        arr = jax.device_put(jnp.asarray(g), js.sharding)
        gt = torch.from_numpy(np.array(g))
        for shard in arr.addressable_shards:
            got = tsp.local_of(gt, ts, tma, where[shard.device.id])
            want = np.asarray(shard.data)
            n += 1
            if tuple(got.shape) != want.shape or not np.array_equal(
                    got.numpy(), want):
                bad.append(f"{name} on {where[shard.device.id]}: local_of "
                           f"{tuple(got.shape)} != shard {want.shape}")
        back = tsp.global_of(lambda c: tsp.local_of(gt, ts, tma, c), ts,
                             tma)
        if not torch.equal(back, gt):
            bad.append(f"{name}: global_of(local_of) is not the array")
    return n, bad


out = {}
cfg_j, cfg_t = J_SMOKES["qwen3-4b"], T_SMOKES["qwen3-4b"]
jfs, tfs = j_flat_spec(cfg_j, 2), make_flat_spec(cfg_t, 2)
for mode in ("dp", "fsdp"):
    out[f"params_{mode}"] = check(
        f"params_{mode}", jsp.param_specs_global(jfs, jma, mode, mesh),
        tsp.param_specs_global(tfs, tma, mode))
    d_loc = sum(int(np.prod(s)) for s in
                local_seg_shapes(tfs, tma, mode).values())
    jd = sum(int(np.prod(s)) for s in
             j_local_seg_shapes(jfs, jma, mode).values())
    assert d_loc == jd, (d_loc, jd)
    out[f"state_{mode}"] = check(
        f"state_{mode}",
        jsp.state_specs_global(jfs, jma, mode, mesh, j_opt("adamw"), jd,
                               with_ef=True),
        tsp.state_specs_global(tfs, tma, mode, t_opt("adamw"), d_loc,
                               with_ef=True))
n, bad = 0, []
for gb in (8, 1):
    a, b = check(f"batch_gb{gb}",
                 jsp.batch_specs_global(cfg_j, jma, mesh, global_batch=gb,
                                        seq_len=16, with_labels=True),
                 tsp.batch_specs_global(cfg_t, tma, global_batch=gb,
                                        seq_len=16, with_labels=True))
    n, bad = n + a, bad + b
out["batch"] = (n, bad)
n, bad = 0, []
for arch in ("qwen3-4b", "rwkv6-7b", "zamba2-2.7b"):
    a, b = check(f"cache_{arch}",
                 jsp.cache_specs_global(J_SMOKES[arch], jma, mesh,
                                        global_batch=4, t_cache=8),
                 tsp.cache_specs_global(T_SMOKES[arch], tma, global_batch=4,
                                        t_cache=8))
    n, bad = n + a, bad + b
out["cache"] = (n, bad)
print(json.dumps(out))
"""

_FAKE_SCRIPT = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import (init_process, make_production_mesh,
                                     mesh_axes_of)
out = {}
for multi, world in ((False, 256), (True, 512)):
    init_process(0, world, local_world=world, store=FakeStore(),
                 backend="fake", device_type="cpu")
    pm = make_production_mesh(multi_pod=multi)
    ma = mesh_axes_of(pm)
    out[str(multi)] = {
        "fields": [ma.tp, ma.data, ma.pod, ma.tp_axis, ma.data_axis,
                   ma.pod_axis],
        "names": list(pm.names), "shape": list(pm.shape),
        "mesh_is_pm": ma.mesh is pm,
        "groups": {"/".join(k): len(pm.axis(k).ranks)
                   for k in (("model",), ("data",), ("pod", "data"),
                             ("data", "model"))}}
    dist.destroy_process_group()
print(json.dumps(out))
"""


def _run(script: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def shards() -> dict:
    return _run(_SPECS_SCRIPT)


@pytest.mark.parametrize("what", ["params_dp", "params_fsdp", "state_dp",
                                  "state_fsdp", "batch", "cache"])
def test_local_of_equals_reference_device_shards(shards, what):
    n, bad = shards[what]
    assert not bad, bad[:10]
    assert n >= 8   # every one of the 8 devices' shards was compared


@pytest.fixture(scope="module")
def production() -> dict:
    return _run(_FAKE_SCRIPT)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_axes_of_production_mesh_matches_reference(production,
                                                        multi_pod):
    got = production[str(multi_pod)]
    shape, names = got["shape"], got["names"]
    ref = j_mesh_axes_of(types.SimpleNamespace(
        axis_names=tuple(names), devices=np.empty(shape)))
    assert got["fields"] == [ref.tp, ref.data, ref.pod, ref.tp_axis,
                             ref.data_axis, ref.pod_axis]
    want = (([2, 16, 16], ["pod", "data", "model"]) if multi_pod
            else ([16, 16], ["data", "model"]))
    assert (shape, names) == want
    assert got["mesh_is_pm"]
    pod = 2 if multi_pod else 1
    assert got["groups"] == {"model": 16, "data": 16, "pod/data": 16 * pod,
                             "data/model": 256}


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_pspec_tree_and_abstract_params_match_reference(arch):
    tp = 16
    jspecs = dict(tree_leaves(j_param_specs(j_get(arch), tp)))
    got_p = dict(tree_leaves(pspec_tree(t_get(arch), tp)))
    got_a = dict(tree_leaves(abstract_params(t_get(arch), None, tp)))
    want_p = dict(tree_leaves(j_pspec_tree(j_get(arch), tp)))
    assert set(got_p) == set(jspecs) == set(got_a) == set(want_p)
    for path, s in jspecs.items():
        assert got_p[path] == tuple(want_p[path]) == tuple(s.pspec), path
        a = got_a[path]
        assert a.device.type == "meta" and tuple(a.shape) == \
            s.local_shape(tp), (path, tuple(a.shape), s.local_shape(tp))
