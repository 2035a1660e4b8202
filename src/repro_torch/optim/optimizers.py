"""Optimizers over flat f32 parameter tensors.

Port of ``repro/optim/optimizers.py``. Updates are elementwise, so they
apply unchanged to (P, f) per-worker segments. ``step`` is the 0-based
step count as a Python int; the bias corrections are computed in f32 as
in the reference. The moment tensors are updated in place (the optimizer
owns them; at full width each is gigabytes).

    opt = make("adamw", lr=1e-3)
    state = opt.init(shape, device)
    params, state = opt.apply(params, grad, state, step)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[..., Any]
    apply: Callable[..., tuple[torch.Tensor, Any]]
    slots: int  # number of f32 tensors of state (memory accounting)


def _lr(lr, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _zeros(shape, device) -> torch.Tensor:
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def sgdm(lr=0.1, momentum: float = 0.9, weight_decay: float = 0.0,
         nesterov: bool = False) -> Optimizer:
    def init(shape, device="cpu"):
        return _zeros(shape, device)

    def apply(p, g, m, step: int):
        g = g + weight_decay * p if weight_decay else g
        m.mul_(momentum).add_(g)
        d = g + momentum * m if nesterov else m
        return p - _lr(lr, step) * d, m

    return Optimizer("sgdm", init, apply, slots=1)


def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(shape, device="cpu"):
        return (_zeros(shape, device), _zeros(shape, device))

    def apply(p, g, state, step: int):
        m, v = state
        t = torch.tensor(step + 1.0, dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1.item()) / (torch.sqrt(v / bc2.item()) + eps)
        upd.add_(weight_decay * p)
        return p - _lr(lr, step) * upd, (m, v)

    return Optimizer("adamw", init, apply, slots=2)


REGISTRY = {"sgdm": sgdm, "adamw": adamw}


def make(name: str, **kw) -> Optimizer:
    return REGISTRY[name](**kw)
