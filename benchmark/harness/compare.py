"""The comparison that decides ``correct``.

Training: the program's and the reference's first steps from the same
weights on the same batches. Three numbers, each against its limit in
``benchmark/limits/<cell>.json``:

- ``loss_gap``: the largest |program - reference| / |reference| of the
  steps' losses;
- ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norms of the first gradient as the optimizer gets it
  (the momentum buffer after one step: gradient plus weight decay), over
  the larger of the reference's norm of that leaf and of the median leaf;
- ``delta_gap``: the same for each parameter's change over the steps;
- ``out_gap``: the root-mean-square gap of the first step's forward
  outputs (the heads, the logits) over the reference's root mean square.

Leaves whose first reference gradient is under a thousandth of the median
leaf's move by round-off alone under the optimizer and are left out of
both leaf numbers.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3  # of the median leaf's gradient: a leaf below moves by round-off


def _leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict[str, float]:
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves}


def _worst(gaps: dict) -> str:
    return max(gaps, key=lambda n: (not math.isfinite(gaps[n]), gaps[n]))


def _rms_gap(prog: list, ref: list) -> float:
    """sqrt(sum (p - r)^2 / sum r^2) over every element; infinite where the
    shapes differ."""
    if [p.shape for p in prog] != [r.shape for r in ref]:
        return math.inf
    num = sum(float(((p.double() - r.double()) ** 2).sum()) for p, r in zip(prog, ref))
    return math.sqrt(num / sum(float((r.double() ** 2).sum()) for r in ref))


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {'loss': [...], 'grad': {leaf: norm}, 'delta':
    {leaf: norm}}; ``ref`` also 'grad_raw' (the first gradient's norms,
    without the decay) for the rule on leaves."""
    if set(prog["grad"]) != set(ref["grad"]) or len(prog["loss"]) != len(ref["loss"]):
        raise RuntimeError("the program's and the reference's leaves or steps differ")
    raw = ref["grad_raw"]
    med = statistics.median(raw.values())
    leaves = [n for n in raw if raw[n] >= NOUGHT * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], leaves)
    delta = _leaf_gaps(prog["delta"], ref["delta"], leaves)
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    g, d = _worst(grad), _worst(delta)
    return {"out_gap": _rms_gap(prog["out"], ref["out"]), "loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": grad[g], "delta_gap": delta[d],
            "grad_median_gap": statistics.median(grad.values()),
            "delta_median_gap": statistics.median(delta.values()),
            "grad_leaf": g, "delta_leaf": d,
            "leaves": len(leaves), "leaves_left_out": len(raw) - len(leaves)}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number finite and within its limit, {name: {'value',
    'limit'}})."""
    check = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
    return ok, check
