"""Shared harness: distributed CNN training with pluggable compressors.

Port of ``benchmarks/cnn_dist.py``: the paper's experimental setup with P
simulated workers on the leading dimension (as ``core/gs_sgd.py``),
ResNet-20 / VGG-16 on CIFAR-geometry synthetic data, SGD with momentum
around the compressor's step. Used by the convergence (Figs. 2-3),
k-sensitivity (Figs. 6-7), time-breakdown (Figs. 4-5) and throughput
(Table II) drivers of this package.

Each worker's gradient is computed as the reference computes it: its row
of the flat parameters is cut into separate leaf tensors
(``count_sketch.unravel_tree``), ``torch.autograd.grad`` takes their
gradients, and they are raveled back in the reference's leaf order. The
leaves are views of the row but leaves of the autograd graph, so no
d-sized gradient is summed per leaf.

Accuracy is taken from the loss's own forward of the pre-update
parameters (the reference runs a second forward of the same parameters
on the same images: the same logits).

On the card the CNN path runs with TF32 off and cuDNN deterministic
(``prepare_device``), so a step's losses are the same bits in every run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any

import torch

from repro_torch.core import compression as comp
from repro_torch.core import count_sketch as cs
from repro_torch.data import ImageStream
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import cnn
from repro_torch.optim.optimizers import sgdm


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT = os.path.join(ROOT, "experiments", "bench_torch")


@dataclasses.dataclass
class RunResult:
    losses: list
    accs: list
    wall_s: float
    stats: Any          # CommStats of the steady-state step
    d: int


def prepare_device(device=None) -> torch.device:
    """The CNN path's device (the card unless ``device`` says otherwise;
    raises without one). On the card: TF32 off for convolutions and
    matmuls, cuDNN deterministic and its autotuner off."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return device


def init_params(model: str, device, width_kw: dict | None = None) -> dict:
    """``model``'s parameters drawn from a generator seeded 0."""
    init, _ = cnn.MODELS[model]
    return init(torch.Generator(device=device).manual_seed(0),
                **(width_kw or {}))


def grad_leaves(flat: torch.Tensor, info) -> tuple[dict, list]:
    """``unravel_tree`` of ``flat`` whose leaves are leaves of the autograd
    graph (views of ``flat``, which takes no gradient): (tree, leaves in
    ``ravel_tree`` order)."""
    tree = cs.unravel_tree(flat.detach(), info)
    return tree, [x.requires_grad_() for x in cs.tree_leaves(tree)]


def make_step(model: str, compressor, P: int, lr: float = 0.05,
              momentum: float = 0.9, width_kw: dict | None = None, *,
              device=None, params: dict | None = None):
    """The P-worker train step. Returns (step, state0, d, stats_box).

    ``step(state, images (P, b, H, W, 3), labels (P, b))`` -> (state,
    (loss, acc)), the loss and accuracy averaged over workers (0-dim
    tensors). ``params``: the starting parameters (default: drawn from
    seed 0). state = (params (P, d), momentum (P, d), compressor state,
    step)."""
    device = prepare_device(device)
    _, apply = cnn.MODELS[model]
    p0 = (params if params is not None
          else init_params(model, device, width_kw))
    flat0, info = cs.ravel_tree(p0)
    flat0 = flat0.to(device)
    d = flat0.shape[0]
    opt = sgdm(lr=lr, momentum=momentum)
    stats_box: dict = {}

    def worker(flat: torch.Tensor, images, labels, g_out: torch.Tensor):
        """One worker's loss and accuracy; its flat gradient into g_out."""
        tree, leaves = grad_leaves(flat, info)
        with torch.enable_grad():
            logits = apply(tree, images)
            loss = cnn.ce_loss(logits, labels)
            grads = torch.autograd.grad(loss, leaves)
        torch.cat([x.reshape(-1) for x in grads], out=g_out)
        return loss.detach(), cnn.accuracy(logits.detach(), labels)

    def step(state, images: torch.Tensor, labels: torch.Tensor):
        params_flat, m, acc, step_i = state
        g = torch.empty((P, d), dtype=torch.float32, device=device)
        losses, accs = zip(*(worker(params_flat[p], images[p], labels[p],
                                    g[p]) for p in range(P)))
        upd, acc, stats = compressor.step(acc, g, nworkers=P)
        stats_box["stats"] = stats
        new_flat, m = opt.apply(params_flat, upd / P, m, step_i)
        return ((new_flat, m, acc, step_i + 1),
                (torch.stack(losses).mean(), torch.stack(accs).mean()))

    state0 = (flat0.expand(P, d).clone(), opt.init((P, d), device),
              compressor.init(d, P, device), 0)
    return step, state0, d, stats_box


def make_compressor(name: str, *, k: int | None = None, rows: int = 5,
                    width: int = 4096):
    """The compressor ``run`` builds: k defaults to 2,048; fetchsgd gets
    momentum 0 (the harness's optimizer provides momentum)."""
    kw: dict = {}
    if name not in ("dense", "signsgd", "powersgd"):
        kw["k"] = k or 2048
    if name in ("gs-sgd", "sketched-sgd", "fetchsgd"):
        kw.update(rows=rows, width=width)
    if name == "fetchsgd":
        kw["momentum"] = 0.0
    return comp.make(name, **kw)


def run(model: str, compressor_name: str, *, P: int = 4, steps: int = 30,
        global_batch: int = 32, k: int | None = None, rows: int = 5,
        width: int = 4096, lr: float = 0.02, seed: int = 0,
        width_kw: dict | None = None, device=None) -> RunResult:
    """Train ``model`` for ``steps`` with the named compressor; P workers,
    batches from ``ImageStream(global_batch, seed)``."""
    device = prepare_device(device)
    compressor = make_compressor(compressor_name, k=k, rows=rows,
                                 width=width)
    step, state, d, stats_box = make_step(model, compressor, P, lr=lr,
                                          width_kw=width_kw, device=device)
    stream = ImageStream(global_batch=global_batch, seed=seed)
    per = global_batch // P
    losses, accs = [], []
    t0 = time.time()
    for i in range(steps):
        b = stream.global_batch_at(i, device)
        state, (loss, acc) = step(
            state, b["images"].reshape(P, per, *b["images"].shape[1:]),
            b["labels"].reshape(P, per))
        losses.append(float(loss))
        accs.append(float(acc))
    wall = time.time() - t0
    return RunResult(losses, accs, wall, stats_box.get("stats"), d)


def device_record(device: torch.device) -> dict:
    """The device a result was measured on."""
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"type": device.type, "name": device.type, "count": 1}


def write_json(results: dict, name: str, out: str | None) -> str:
    out = out or OUT
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, name)
    with open(path, "w") as fh:
        json.dump(results, fh, indent=1)
    return path


def cli(driver, doc: str, argv=None, **extra):
    """The drivers' shared command line: ``--device`` (default the card)
    and ``--out`` (default ``experiments/bench_torch/``)."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--out", default=None, help="directory of the JSON")
    for flag, (typ, default) in extra.items():
        ap.add_argument(f"--{flag}", type=typ, default=default)
    args = ap.parse_args(argv)
    return driver(**vars(args))
