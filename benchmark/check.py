"""The comparison that decides ``correct``.

Both sides give the same readings of the first steps of one
training state (:func:`benchmark.reference.decoder_lm.train` for the
reference; :func:`benchmark.run.program_readings` for the program):
each step's loss, each leaf's first gradient norm, and the norm of each
leaf's change over those steps. Three numbers are compared:

- ``loss_gap``: |program - reference| / |reference| of the first step's
  loss. The later steps' losses are read and kept, not compared: after
  the first AdamW step (close to lr * sign(g) on every element) the loss
  jumps, and there its gap swings from seed to seed as widely for the
  program as for the float8 control (``PERF.md``);
- ``grad_gap``: over the moving leaves, the largest gap between the two
  norms of the first gradient, over the reference's norm of that leaf;
- ``change_gap``: over the moving leaves, the largest gap between the
  two norms of the parameters' change, over the reference's norm of
  that leaf or of the median leaf's change, whichever is larger (the
  bfloat16 state leaves the norm gains where they were on both sides,
  so their own change is 0).

A leaf moves when its reference gradient is at least a thousandth of the
median leaf's; a leaf below that moves by round-off alone.

A run is correct when each number that the cell's limits name is finite
and at most its limit.
"""

from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "change_gap")
MOVING = 1e-3        # a leaf's gradient over the median leaf's


def _worst_leaf(prog: dict[str, float], ref: dict[str, float],
                leaves, floor: float = 0.0) -> float:
    worst = 0.0
    for n in leaves:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def compare(prog: dict, ref: dict) -> dict[str, float]:
    """The three numbers of one run (module docstring)."""
    if sorted(prog["grad_norms"]) != sorted(ref["grad_norms"]):
        raise ValueError("program and reference hold different leaves")
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("program and reference ran different steps")
    loss = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    leaves = sorted(ref["grad_norms"])
    median = statistics.median(ref["grad_norms"][n] for n in leaves)
    moving = [n for n in leaves if ref["grad_norms"][n] >= MOVING * median]
    return {
        "loss_gap": loss if math.isfinite(loss) else math.inf,
        "grad_gap": _worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                moving),
        "change_gap": _worst_leaf(
            prog["change_norms"], ref["change_norms"], moving,
            statistics.median(ref["change_norms"][n] for n in moving))}


def verdict(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) against the cell's limits. A
    number that the limits leave out has no upper reading in that cell
    and is not compared (the limits file says why)."""
    shown = {n: {"value": numbers[n], "limit": float(limits[n])}
             for n in NAMES if n in limits}
    if not shown:
        raise ValueError("the limits compare none of " + ", ".join(NAMES))
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
