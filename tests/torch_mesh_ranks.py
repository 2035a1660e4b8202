"""Rank bodies for tests/test_torch_mesh.py: each runs in a process of its
own (``launch.mesh.spawn``, gloo on the CPU), builds a process mesh and
runs the port's train or serve step, or the tree or psum all-reduce, on
it. Torch only: the processes import nothing of JAX, so they start
fast."""

from __future__ import annotations

import numpy as np
import torch


def _setup(case: dict):
    from repro_torch.launch.mesh import make_mesh, mesh_axes_of
    torch.set_num_threads(1)
    pm = make_mesh(case["shape"], case["axes"])
    return pm, mesh_axes_of(pm)


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def train_params(case: dict, ts, ma):
    """The one-replica params every process starts from (the simulation's
    ``state_from`` input), from the case's numpy segments."""
    from repro_torch.core.gs_sgd import local_seg_shapes
    from repro_torch.models.flatten import params_from_numpy
    dev = case.get("device", "cpu")
    if ma.tp > 1:
        return params_from_numpy(case["params"], ts.fs, dev,
                                 shapes=local_seg_shapes(ts.fs, ma, "dp"),
                                 lead=(ma.tp,))
    return params_from_numpy(case["params"], ts.fs, dev)


def build_step(case: dict, ma):
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import make_train_step
    from repro_torch.optim import make as make_opt
    opt = make_opt(*case["opt"][:1], **case["opt"][1])
    ts = make_train_step(SMOKES[case["arch"]], ma, opt,
                         dp_mode=case.get("dp_mode", "dp"), remat=False,
                         dtype=torch.float32,
                         device=case.get("device", "cpu"), **case["kw"])
    return opt, ts


def run_steps(ts, state, batches, include=None) -> tuple[dict, dict]:
    """The steps over the global ``batches``; ``include``: a straggler
    mask a step (every worker's flags, or None), of which a process of a
    mesh passes its own worker's."""
    out = {"loss": [], "worker_loss": [], "gnorm": [], "ef": []}
    pm = ts.ma.mesh
    for i, gb in enumerate(batches):
        inc = include[i] if include else None
        if inc is not None:
            inc = torch.tensor(inc, device=ts.device)
            if pm is not None:
                inc = inc[pm.worker():pm.worker() + 1]
        state, m = ts.fn(state, ts.shard(
            {k: torch.from_numpy(np.array(v)).to(ts.device)
             for k, v in gb.items()}), inc)
        out["loss"].append(float(m["loss"]))
        out["worker_loss"].append(_host(m["worker_loss"]))
        out["gnorm"].append(_host(m["grad_norm"]))
        out["ef"].append(_host(state["ef"]))
    out["params"] = _host(state["params"])
    return state, out


def train_case(case: dict) -> dict:
    """The case's steps on its mesh: losses, norms, EF every step, the
    first and the last params, the kernels' launches; this process's
    coordinates; and every collective the steps issued, in order (kind,
    axes, shape; ``core.pgroup.tally``)."""
    from repro_torch.core import pgroup
    from repro_torch.kernels.dispatch import LAUNCHES
    pm, ma = _setup(case)
    opt, ts = build_step(case, ma)
    state = ts.state_from(train_params(case, ts, ma), opt)
    params0 = _host(state["params"])
    LAUNCHES.clear()
    with pgroup.tally() as calls:
        _, out = run_steps(ts, state, case["batches"], case.get("include"))
    return dict(out, params0=params0, coords=dict(pm.coords),
                worker=pm.worker(), launches=dict(LAUNCHES),
                backend=pm.backend,
                collectives=[(c["kind"], c["axes"], c["shape"])
                             for c in calls])


def tree_case(case: dict) -> dict:
    """``allreduce.tree_allreduce`` over the data axis of this worker's
    row of ``case["x"]`` (P, n)."""
    from repro_torch.core import allreduce as ar
    pm, ma = _setup(case)
    x = torch.from_numpy(np.array(case["x"]))[pm.worker()][None]
    with ar.over(pm.axis("data")):
        y = ar.tree_allreduce(x, ma.data)
    return {"y": _host(y), "worker": pm.worker()}


def psum_case(case: dict) -> dict:
    """``allreduce.psum_allreduce`` (the ordered all-reduce beyond two
    processes) over the data axis of this worker's row of ``case["x"]``."""
    from repro_torch.core import allreduce as ar
    pm, ma = _setup(case)
    x = torch.from_numpy(np.array(case["x"]))[pm.worker()][None]
    with ar.over(pm.axis("data")):
        y = ar.psum_allreduce(x, ma.data)
    return {"y": _host(y), "worker": pm.worker()}


def serve_case(case: dict) -> dict:
    """Prefill, then decode steps fed the case's tokens, at tp = 2 on a
    model-only mesh, in the case's dtype and wire (``comm``: the fp8
    wire's dtype, or None): this rank's logits shard and ids."""
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import make_serve_fns
    from repro_torch.models import model as mdl
    pm, ma = _setup(case)
    cfg = SMOKES[case["arch"]]
    dtype, comm = case.get("dtype", torch.float32), case.get("comm")
    prefill, decode = make_serve_fns(cfg, ma, dtype=dtype, comm_dtype=comm)
    ts_params = {k: torch.from_numpy(np.array(v))
                 for k, v in case["params"].items()}
    mine = {k: v[pm.coord("model"):pm.coord("model") + 1]
            for k, v in ts_params.items()}
    tokens = torch.from_numpy(np.array(case["tokens"]))
    cache = mdl.init_cache(cfg, tokens.shape[0], case["t_cache"], dtype,
                           ctx=ma.ctx(dtype, comm))
    logits, cache = prefill(mine, {"tokens": tokens}, cache)
    ids = []
    kv_len = tokens.shape[1]
    for t in case["feed"]:
        tok, cache = decode(mine, torch.from_numpy(np.array(t)), kv_len,
                            cache)
        ids.append(_host(tok))
        kv_len += 1
    return {"logits": _host(logits), "ids": ids,
            "coords": dict(pm.coords)}


CASES = {"train": train_case, "tree": tree_case, "psum": psum_case,
         "serve": serve_case}


def run_cases(rank: int, cases: list[dict]) -> list[dict]:
    """Every case in order (``case["kind"]`` picks its runner: train,
    tree, serve), each on a mesh of its own over this world."""
    return [CASES[case["kind"]](case) for case in cases]
