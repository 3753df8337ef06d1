"""The comparison that decides `correct`: a program's first three meta-steps
against the plain reference's (float32, TF32 off, as the configuration
states), from the same theta and the same tasks.

Three numbers, each held to a limit of its own (`limits/<cell>.json`, set
from the readings that PERF.md gives):

- `loss`: the relative gap between the program's first meta-loss and the
  reference's (the later steps' losses follow Adam's first step, below,
  and are only reported, `loss_worst`);
- `grad1`: the first meta-gradient as the optimizer got it, by the worst
  leaf: the gap between the program's norm of a leaf and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
- `update3`: the same for each leaf's change from theta after the three
  steps, at the median leaf (the worst is reported, `update3_worst`).
  Adam's first step moves a parameter by about its learning rate whatever
  the size of its gradient, so where a gradient is nought to rounding (a
  bias that shifts every centre alike, which the prototype loss does not
  see) the two sides move it by the sign of their own rounding. Leaves
  whose first reference gradient is below a thousandth of the median
  leaf's (the head's bias) are left out.
"""

from __future__ import annotations

import statistics
from typing import Sequence

import torch

ZERO_GRAD = 1e-3   # of the median leaf's first gradient norm


def _norms(xs: Sequence[torch.Tensor]):
    return [float(torch.linalg.vector_norm(x.double())) for x in xs]


def _gaps(prog, ref, keep=None):
    """Per leaf: the gap of the norms over the larger of the reference's
    norm of that leaf and of the median leaf."""
    keep = range(len(ref)) if keep is None else keep
    med = statistics.median([ref[i] for i in keep])
    return [abs(prog[i] - ref[i]) / max(ref[i], med, 1e-300) for i in keep]


def readings(theta0, prog: dict, ref: dict) -> dict:
    """The three numbers, and the others named above. prog and ref:
    {"losses", "grad1", "theta"} as Reference.run returns them (the
    program's read off its state); theta0 the parameters both started
    from."""
    losses = [abs(p - r) / max(abs(r), 1e-300)
              for p, r in zip(prog["losses"], ref["losses"])]
    g_ref = _norms(ref["grad1"])
    grad1 = _gaps(_norms(prog["grad1"]), g_ref)
    med = statistics.median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= ZERO_GRAD * med]
    t0 = [t.double().cpu() for t in theta0]

    def change(theta):
        return _norms([t.double().cpu() - a for t, a in zip(theta, t0)])
    update3 = _gaps(change(prog["theta"]), change(ref["theta"]), keep)
    return {"loss": losses[0], "grad1": max(grad1),
            "update3": statistics.median(update3),
            "loss_worst": max(losses),
            "grad1_median": statistics.median(grad1),
            "update3_worst": max(update3), "loss_steps": losses,
            "grad1_leaves": grad1, "update3_leaves": update3}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: correct when each is finite and within it."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
