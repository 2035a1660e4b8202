"""Error feedback for sparsified/sketched distributed SGD.

Port of ``repro/core/error_feedback.py``. With u_p = acc_p + g_p and a
globally selected index set I (identical on every worker), the residual is
acc_p' = u_p with coordinates I zeroed. Tensors carry the worker axis
first: acc, g, u are (P, d) and idx is (P, k).
"""

from __future__ import annotations

import torch


def init(d: int, nworkers: int = 1, dtype=torch.float32,
         device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.zeros((nworkers, d), dtype=dtype, device=device)


def add(acc: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """u = acc + g (the vector that gets compressed this step)."""
    return acc + g.to(acc.dtype)


def residual_global(u: torch.Tensor, idx: torch.Tensor, *,
                    inplace: bool = False) -> torch.Tensor:
    """acc' = u with the globally-selected coordinates zeroed (per worker).

    ``inplace=True`` zeroes ``u`` itself — the caller's ``u`` is dead after
    the residual, and at full width a second (P, d) vector is gigabytes.
    """
    out = u if inplace else u.clone()
    return out.scatter_(-1, idx, 0.0)


def residual_dense(u: torch.Tensor, applied: torch.Tensor) -> torch.Tensor:
    """acc' = u - applied, for compressors returning a dense local update."""
    return u - applied
