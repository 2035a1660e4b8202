"""One provenance stamp for every artifact (trace@2, TunePlan).

Port of ``repro/obs/provenance.py``: the same schema
(``repro.obs/provenance@1``) and keys, with the reference's ``jax``
version field replaced by ``torch`` and ``cuda`` (``torch.version.cuda``).
``backend`` is the run's device type, ``"cuda"`` or ``"cpu"`` (``device``:
the run's device; None = the card when there is one); on the card
``device_kind`` is ``torch.cuda.get_device_name`` and ``device_count``
``torch.cuda.device_count()``, on the CPU ``"cpu"`` and 1. ``runspec_sha256`` is
the sha256 of the resolved ``RunSpec`` JSON, so two artifacts are
comparable iff their spec hashes match. The host fields (hostname, git
revision) are best-effort: ``None`` rather than raising on an exotic host.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import socket
import subprocess

import torch

SCHEMA = "repro.obs/provenance@1"

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def runspec_hash(spec) -> str:
    """sha256 of the canonical resolved-spec JSON (sorted keys)."""
    doc = spec.to_json() if hasattr(spec, "to_json") else spec
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _git_rev() -> str | None:
    try:
        out = subprocess.run(
            ["git", "-C", _REPO_ROOT, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def provenance(spec=None, device=None) -> dict:
    out: dict = {"schema": SCHEMA, "torch": torch.__version__,
                 "cuda": torch.version.cuda}
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    out["backend"] = device.type
    if device.type == "cuda":
        out["device_kind"] = torch.cuda.get_device_name(device)
        out["device_count"] = torch.cuda.device_count()
    else:
        out["device_kind"] = "cpu"
        out["device_count"] = 1
    try:
        out["hostname"] = socket.gethostname()
    except OSError:
        out["hostname"] = None
    out["platform"] = platform.platform()
    out["python"] = platform.python_version()
    out["git_rev"] = _git_rev()
    if spec is not None:
        out["runspec_sha256"] = runspec_hash(spec)
    return out
