"""Whether a run is correct: its readings against the reference's.

Four numbers, and a fifth that the cell's loss names, each against the
limit in the cell's limits file:

* ``loss_gap``: the largest relative gap ``|L - L_ref| / |L_ref|`` over the
  first two epochs' losses (each the sum of the epoch's steps; per style in
  a multi-style cell), as the port logs them;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  first gradient as Adam holds it and the reference's, divided by the
  larger of the reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of the leaves' change after three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
* ``grad_diff``: over the leaves, the largest norm of the difference of the
  first gradients, divided as ``grad_gap``'s. The three gaps of norms and
  losses cannot tell the port's precision from the one below it (a gap of
  sums is a signed sum of rounding errors, small by chance for a coarse
  format on some seeds); the first gradient is a pure function of the
  inputs, and its difference measures the arithmetic element by element;
* the loss's ``FIRST_STEP`` (``gram_diff`` for the Gram loss): over the
  keys of its first-step statistic (and styles), the largest
  ``||S - S_ref|| / ||S_ref||``, the port's as ``port_first_step`` picks
  it from its first VGG call with a gradient, the reference's as
  ``first_step`` computes it (``portbench/losses/<loss>.py`` says what it
  is and why).

A reading the run lacks, one of another shape, or one that is not finite,
reads infinity. A
number whose limit is ``null`` in the limits file is not compared (it has
no upper reading: neither the control nor a fault fails it).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

NOUGHT = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_diff")


def numbers(loss) -> tuple:
    """The names of the numbers compared in a cell with ``loss``."""
    return NUMBERS + (loss.FIRST_STEP,)


def unlimited(loss) -> dict:
    """Every number compared, as the calibration reads them."""
    return {n: {"limit": math.inf} for n in numbers(loss)}


def _finite(x) -> float:
    return float(x) if x is not None and math.isfinite(x) else math.inf


def loss_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    gaps = [abs(_finite(prog.get(k)) - r) / abs(r) for k, r in ref.items()]
    return max(gaps) if gaps else math.inf


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None
             ) -> float:
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return math.inf
    med = statistics.median(ref.values())
    return max(abs(_finite(prog.get(k)) - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def diff_gap(prog: Dict[str, "torch.Tensor"], ref: Dict[str, "torch.Tensor"]
             ) -> float:
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    if not norms:
        return math.inf
    med = statistics.median(norms.values())
    gaps = []
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or p.shape != r.shape:
            return math.inf
        gaps.append(_finite(float((p.double() - r.double()).norm()))
                    / max(norms[k], med, 1e-30))
    return max(gaps)


def rel_diff(prog: Dict[str, "torch.Tensor"], ref: Dict[str, "torch.Tensor"]
             ) -> float:
    """max over ``ref``'s keys of ``||p - r|| / ||r||``, each tensor
    against its own norm."""
    if not ref:
        return math.inf
    gaps = []
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or p.shape != r.shape:
            return math.inf
        r = r.double()
        gaps.append(_finite(float((p.double() - r).norm()))
                    / max(float(r.norm()), 1e-30))
    return max(gaps)


def compare(prog: dict, ref: dict, limits: dict, loss) -> Dict[str, dict]:
    """{name: {"value", "limit"}} in a fixed order."""
    med = statistics.median(ref["first_grad"].values())
    moving = {k for k, v in ref["first_grad"].items() if v >= NOUGHT * med}
    values = {
        "loss_gap": loss_gap(prog["epoch_loss"], ref["epoch_loss"]),
        "grad_gap": norm_gap(prog["first_grad"], ref["first_grad"]),
        "change_gap": norm_gap(prog["change"], ref["change"], moving),
        "grad_diff": diff_gap(prog["first_grad_t"], ref["first_grad_t"]),
        loss.FIRST_STEP: rel_diff(prog.get("first_step", {}),
                                  ref.get("first_step", {})),
    }
    return {k: {"value": v, "limit": float(limits[k]["limit"])}
            for k, v in values.items() if limits[k].get("limit") is not None}
