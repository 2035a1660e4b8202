"""The numbers that decide ``correct``, from the program's and the
reference's readings of the first three steps of one seed:

    loss_gap    the largest over the steps of |loss_p - loss_r| / |loss_r|
    grad_gap    the first update as the optimizer got it (the program's
                worked out from its first moment after one step: m / (1 -
                b1)), by the worst leaf: |norm_p - norm_r| over the larger
                of norm_r and the median leaf's norm_r
    change_gap  the parameters' change after the three steps, by the worst
                leaf, measured the same way; leaves whose dense gradient
                (the workers' mean, before the exchange) is under a
                thousandth of the median leaf's in the reference are left
                out, since they can only move by round-off

A run is correct when every number is finite and within its limit
(``limits/<cell>.json``, with the readings it was set from).
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
QUIET = 1e-3   # a leaf's share of the median dense gradient left out


def _gaps(prog: dict, ref: dict, names) -> dict:
    med = statistics.median(ref[n] for n in ref)
    out = {}
    for n in names:
        den = max(ref[n], med)
        gap = abs(prog[n] - ref[n]) / den if den > 0 else abs(prog[n])
        out[n] = gap if math.isfinite(gap) else float("inf")
    return out


def _worst(prog: dict, ref: dict, names) -> float:
    return max(_gaps(prog, ref, names).values())


def _moved(ref: dict) -> list:
    """The leaves the change is compared on (module docstring)."""
    med = statistics.median(ref["dense"].values())
    return [n for n, v in ref["dense"].items() if v >= QUIET * med]


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The leaves behind grad_gap and change_gap: the n worst of each,
    with the gap, both norms and the median the gap is taken against,
    and how many leaves the change left out."""
    out = {}
    for key in ("grad", "change"):
        names = _moved(ref) if key == "change" else list(ref[key])
        gaps = _gaps(prog[key], {m: ref[key][m] for m in names}, names)
        med = statistics.median(ref[key][m] for m in names)
        out[key] = [[m, gaps[m], prog[key][m], ref[key][m], med] for m in
                    sorted(gaps, key=gaps.get, reverse=True)[:n]]
    out["left_out"] = len(ref["dense"]) - len(_moved(ref))
    return out


def numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"loss": [3 floats], "grad": {leaf: norm}, "change":
    {leaf: norm}}; ref also "dense": {leaf: norm}."""
    loss = max((abs(a - b) / abs(b) if math.isfinite(a) else float("inf"))
               for a, b in zip(prog["loss"], ref["loss"]))
    moved = _moved(ref)
    return {"loss_gap": loss,
            "grad_gap": _worst(prog["grad"], ref["grad"], ref["grad"]),
            "change_gap": _worst(prog["change"],
                                 {n: ref["change"][n] for n in moved},
                                 moved)}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}})."""
    checks = {n: {"value": nums[n], "limit": limits[n]["limit"]}
              for n in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
