"""The numbers that decide ``correct``, each against its cell's limit.

Training: the program's first steps against the reference's, by three
numbers:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  clipped gradient (the program's worked out from AdamW's first moment
  after step 1), over the larger of the reference's norm of that leaf
  and of the median leaf;
* ``change_gap``: the same of each parameter's change over the followed
  steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's (zero to rounding) count in neither of the last two: AdamW moves
them by round-off alone.

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, over the sampled
requests.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the norm gaps
ZERO_GRAD_SHARE = 1e-3


def leaf_gaps(prog: Dict, ref: Dict, what: str) -> Dict[str, float]:
    """Each counted leaf's gap of ``what`` (``grad_norms`` or
    ``change``)."""
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= ZERO_GRAD_SHARE * med]
    want = ref[what]
    floor = statistics.median(want[k] for k in keep)
    return {k: abs(prog[what][k] - want[k]) / max(want[k], floor)
            for k in keep}


def training(prog: Dict, ref: Dict, limits: Dict) -> Dict[str, Dict]:
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    values = {"loss_gap": loss_gap,
              "grad_gap": max(leaf_gaps(prog, ref, "grad_norms").values()),
              "change_gap": max(leaf_gaps(prog, ref, "change").values())}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def serving(gap: float, limits: Dict) -> Dict[str, Dict]:
    return {"logit_gap": {"value": gap, "limit": limits["logit_gap"]}}


def correct(checks: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
