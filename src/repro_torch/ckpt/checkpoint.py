"""Checkpoint/restore: atomic, keep-N, optionally async, bit-exact resume.

Port of ``repro/ckpt/checkpoint.py``. Layout: ``<dir>/step_<N>/`` holding
one ``.npy`` per leaf of the state (the train step's dict of tensors;
leaves in sorted-key order, as ``jax.tree_util`` flattens a dict) plus
``meta.json`` (the tree's description, step, and what the caller adds:
data cursor, generator states, device). A checkpoint directory is written
under a ``.tmp-`` prefix and renamed only after every array is flushed, so
a worker dying mid-save never corrupts the latest complete checkpoint.

Per-host sharded saving: each host passes ``shard=(host_id, n_hosts)``
and writes only its own leaf files (``leaf_<i>.h<host>.npy``); on one
host that is one shard, but the layout is the deployable one.

``restore`` puts the tensors on the caller's device. ``AsyncCheckpointer``
copies the state to host memory synchronously (the optimizer and the
error feedback update their tensors in place, so the copy is taken before
the next step) and writes the files on a thread; ``wait()`` joins it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def flatten(tree: Any, path: str = "") -> tuple[list, list[str]]:
    """Leaves and their paths: dicts by sorted key, tuples and lists in
    order; anything else (tensor, number) is a leaf."""
    if isinstance(tree, dict):
        leaves, paths = [], []
        for k in sorted(tree):
            lv, ps = flatten(tree[k], f"{path}/{k}")
            leaves += lv
            paths += ps
        return leaves, paths
    if isinstance(tree, (tuple, list)):
        leaves, paths = [], []
        for i, v in enumerate(tree):
            lv, ps = flatten(v, f"{path}/{i}")
            leaves += lv
            paths += ps
        return leaves, paths
    return [tree], [path or "/"]


def unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``
    (consumed)."""
    if isinstance(like, dict):
        out = {k: unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(unflatten(v, leaves) for v in like)
    return leaves.pop(0)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host array (bf16 as its int16 bits: numpy has no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    return (str(leaf.dtype).removeprefix("torch.")
            if isinstance(leaf, torch.Tensor) else type(leaf).__name__)


def save(ckpt_dir: str, step: int, state: Any, meta: dict | None = None,
         *, keep: int = 3, shard: tuple[int, int] = (0, 1)) -> str:
    """Write ``state`` (a tree of tensors) at ``step``. Returns final path."""
    host, n_hosts = shard
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step}.h{host}")
    os.makedirs(tmp, exist_ok=True)

    leaves, paths = flatten(state)
    for i, leaf in enumerate(leaves):
        path = os.path.join(tmp, f"leaf_{i:04d}.h{host}.npy")
        with open(path + ".part", "wb") as f:
            np.save(f, _to_numpy(leaf))
            f.flush()
            os.fsync(f.fileno())
        os.rename(path + ".part", path)

    m = dict(meta or {})
    m.update(step=step, n_leaves=len(leaves), paths=paths,
             dtypes=[_dtype_name(x) for x in leaves], host=host,
             n_hosts=n_hosts)
    with open(os.path.join(tmp, f"meta.h{host}.json"), "w") as f:
        json.dump(m, f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())

    if host == 0:  # host 0 commits (single-host: always)
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, dtype: str, like, device):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item()) if arr.ndim == 0 else arr
    t = torch.from_numpy(arr.copy())
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device if device is None else device)


def restore(ckpt_dir: str, state_like: Any, step: int | None = None,
            *, shard: tuple[int, int] = (0, 1),
            device: str | torch.device | None = None) -> tuple[Any, dict]:
    """Load ``step`` (default: latest). ``state_like`` supplies the tree;
    tensors go to ``device`` (default: each like-leaf's device), numbers
    come back as the like-leaf's type.

    Returns (state, meta). Array dtypes and shapes come from disk.
    """
    host, _ = shard
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, f"meta.h{host}.json")) as f:
        meta = json.load(f)
    leaves_like, _ = flatten(state_like)
    n = meta["n_leaves"]
    if n != len(leaves_like):
        raise ValueError(f"leaf count mismatch: ckpt {n} vs state "
                         f"{len(leaves_like)}")
    leaves = [_from_numpy(
        np.load(os.path.join(d, f"leaf_{i:04d}.h{host}.npy")),
        meta["dtypes"][i], like, device) for i, like in enumerate(leaves_like)]
    return unflatten(state_like, leaves), meta


def _host_copy(tree: Any) -> Any:
    """Every tensor of ``tree`` copied to host memory now."""
    leaves, _ = flatten(tree)
    return unflatten(tree, [x.detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else x
                             for x in leaves])


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one in flight at a time)."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 shard: tuple[int, int] = (0, 1)):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.shard = shard
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any, meta: dict | None = None) -> None:
        self.wait()
        snap = _host_copy(state)  # before the next step updates in place

        def work():
            try:
                save(self.ckpt_dir, step, snap, meta, keep=self.keep,
                     shard=self.shard)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
