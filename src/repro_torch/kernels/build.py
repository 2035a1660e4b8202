"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/kernels/lib<name>-<hash>.so`` at the repo root (a directory
``.gitignore`` lists) at first use, then loaded with ``ctypes``. The file
name carries a hash of the flags, the source and every ``csrc`` header it
includes (``#include "x.cuh"``, followed recursively), so an edited source
or header is rebuilt and a stale library is never loaded. ``build_all``
starts one ``nvcc`` per source, all in parallel.

Nothing here runs at import time: the CPU tests import every module, and
``nvcc`` is needed only when a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(CSRC)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(name: str) -> list[str]:
    """``<name>.cu`` and the ``csrc`` headers it includes, recursively."""
    out, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f not in out:
            out.append(f)
            with open(os.path.join(CSRC, f), "rb") as fh:
                todo += [m.decode() for m in
                         _LOCAL_INCLUDE.findall(fh.read())]
    return out


def _target(name: str) -> tuple[str, str]:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources(name):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    src = os.path.join(CSRC, f"{name}.cu")
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names) -> dict[str, str]:
    """Compile every named source in parallel; returns nvcc's log per name
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name)[1])
            _libs[name] = lib
        return lib
