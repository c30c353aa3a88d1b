"""The numbers that decide ``correct``: a candidate (the program, or the
control or a fault put in its place) against the plain reference.

Training cells, after the first three steps from one state:
``loss_gap``   the largest gap of a step's loss, over the reference's loss
               (``first_loss_gap``: the first step's alone);
``grad_gap``   the worst leaf's gap between the norms of the first step's
               gradient (the candidate's as its optimizer got it), over the
               reference's norm of that leaf or of the median leaf,
               whichever is larger;
``change_gap`` the same of the norms of each leaf's change over the three
               steps, leaving out leaves whose reference gradient is under a
               thousandth of the median leaf's (Adam moves those by
               round-off alone);
``grad_diff``  the norm of the difference of the first gradients, over the
               same norm, of the worst leaf (``grad_diff_median``: of the
               median leaf). A gap of norms or of losses is a signed sum of
               rounding errors and spreads from near 0 to several times its
               median over seeds; a difference norm does not;
``coh_gap``    (Phase E) the largest gap of the coherence loss of the steps
               that have one, over the reference's.
View cells, over rays sampled from the frames the window produced:
``rgb_rmse``, ``depth_rmse`` (and ``acc_rmse``) against the reference's.
Which of these a cell compares, and the limits, are in its workload file.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(cand: Dict[str, float], ref: Dict[str, float], keep=None) -> List[float]:
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return [abs(cand[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def train_readings(cand: Dict, ref: Dict, params0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``cand`` and ``ref``: ``{"losses": [..], "grad0": {leaf: tensor},
    "params": {leaf: tensor after the steps}}``; ``params0``: the leaves
    before the first step."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(cand["losses"], ref["losses"])]
    g_ref = _norms(ref["grad0"])
    med = statistics.median(g_ref.values())
    moved = {k for k, v in g_ref.items() if v >= 1e-3 * med}
    change = lambda rec: _norms({k: rec["params"][k].float() - params0[k].float()
                                 for k in rec["params"]})
    grads = leaf_gaps(_norms(cand["grad0"]), g_ref)
    changes = leaf_gaps(change(cand), change(ref), moved)
    diffs = _norms({k: cand["grad0"][k].float() - ref["grad0"][k].float() for k in g_ref})
    rel_diffs = [diffs[k] / max(g_ref[k], med, 1e-30) for k in g_ref]
    out = {"loss_gap": max(losses), "first_loss_gap": losses[0],
           "grad_gap": max(grads), "change_gap": max(changes),
           "grad_diff": max(rel_diffs), "grad_diff_median": statistics.median(rel_diffs)}
    if "coh_losses" in ref:  # the first step has no previous buffers: 0 on both sides
        out["coh_gap"] = max(abs(a - b) / max(abs(b), 1e-30)
                             for a, b in zip(cand["coh_losses"][1:], ref["coh_losses"][1:]))
    return out


def view_readings(cand: torch.Tensor, ref: torch.Tensor, names: List[str]) -> Dict[str, float]:
    """RMSE of each output column (``names``, e.g. rgb ×3, depth, acc)."""
    out = {}
    diff = (cand.double() - ref.double()) ** 2
    for name in dict.fromkeys(names):
        cols = [i for i, n in enumerate(names) if n == name]
        out[f"{name}_rmse"] = float(diff[:, cols].mean().sqrt())
    return out
