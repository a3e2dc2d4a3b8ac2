"""The numbers that decide ``correct``: the program's readings of its first
three train steps against the reference's.

- ``loss_gap``: the largest relative gap of a step's trained total (the D
  total at iteration 0, the G total at 1 and 2).
- ``grad_gap``: by the worst leaf, the gap between the program's and the
  reference's norm of each optimizer's first gradient (g + wd * p), over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger.
- ``change_gap``: the same of each leaf's change after the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).
- ``dgrad_median_gap``: the median leaf's gap of the discriminators' first
  gradient (iteration 0, before any update). Adam's first step moves every
  element by about the learning rate whatever its gradient's size, so
  elements whose gradient is within rounding of zero step either way, and
  every number read after iteration 0 carries that noise at the level of
  any rounding; the worst leaf is a small one. The median leaf at
  iteration 0 is what a lower precision moves and the noise does not.

A cell's ``limits`` (``workloads/<cell>.json``) name which of these it
compares.
"""

from __future__ import annotations

import math
import statistics

SKIP_BELOW = 1e-3


def _largest(values: list) -> float:
    """The largest value; NaN where any value is not finite."""
    return max(values) if all(math.isfinite(v) for v in values) else math.nan


def _per_leaf(prog: list, ref: list, keep: list) -> list:
    """Each kept leaf's gap over max(its reference norm, the kept leaves'
    median); None for a leaf left out."""
    med = statistics.median(r for r, k in zip(ref, keep) if k)
    return [abs(p - r) / max(r, med) if k else None
            for p, r, k in zip(prog, ref, keep, strict=True)]


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{"grad_gap" | "change_gap": {"dis" | "gen": [gap or None a leaf]}}."""
    out = {"grad_gap": {}, "change_gap": {}}
    for which in ("dis", "gen"):
        rg = ref["grad_norms"][which]
        out["grad_gap"][which] = _per_leaf(prog["grad_norms"][which], rg, [True] * len(rg))
        floor = SKIP_BELOW * statistics.median(rg)
        out["change_gap"][which] = _per_leaf(prog["change_norms"][which],
                                             ref["change_norms"][which],
                                             [g >= floor for g in rg])
    return out


def gaps(prog: dict, ref: dict) -> dict:
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    per = leaf_gaps(prog, ref)
    dgrad = per["grad_gap"]["dis"]
    return {"loss_gap": _largest(loss),
            **{k: _largest([g for which in v.values() for g in which if g is not None])
               for k, v in per.items()},
            "dgrad_median_gap": (statistics.median(dgrad) if all(map(math.isfinite, dgrad))
                                 else math.nan)}
