"""The comparison that decides ``correct``: the program's first three
training steps against the plain reference's, number by number, each
against the limit in the cell's file. The first step runs eagerly (the
block's warm-up), the second and third are replays of the captured epoch
that the window times. The reference does step 1 from the benchmark's own
initial weights and zero moments, and each later step from the
parameters and moments the program held before it (``gnn.follow``), so
that each step is judged alone: AdamW's first step moves every element by
``±lr`` by its gradient's sign, so two float32 runs that follow their own
states part where a gradient lies within rounding of 0, and on a few
seeds in a hundred they part by more than the TF32 control does.

* ``loss_gap``: the largest relative gap of a step's loss;
* ``val_loss_gap``: the largest relative gap of the val loss after a step
  (the val forward of the parameters that step made, each side its own);
* ``grad_gap``: over the steps and the leaves, the largest gap between the
  norms of the program's gradient (the eager step's from AdamW's first
  moment, ``(1 - b1) g``; each replay's as it leaves it in ``.grad``) and
  the reference's, over the larger of that leaf's reference norm and the
  step's median leaf's;
* ``change_gap``: the same gap for each step's change of the parameters,
  over the steps and the leaves, leaving out leaves whose first reference
  gradient is under a thousandth of the median leaf's (they move by
  round-off alone);
* ``keep_z``, ``edge_cover``: the dropout masks' own checks
  (``masks.py``);
* ``nonfinite_epochs``: epochs of the window whose row was not finite.
"""

from __future__ import annotations

import statistics

import torch

#: the training steps that are compared
CHECK_STEPS = 3
#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of ``change_gap``
STILL_LEAF = 1e-3


def _norms(leaves: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def _leaf_gaps(prog: dict[str, float], ref: dict[str, float],
               keep=None) -> list[float]:
    med = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if keep is None or k in keep]


def _rel_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def numbers(prog, ref) -> dict[str, float]:
    """The compared numbers of two ``reference.gnn.Readings``-like runs:
    ``prog`` is judged against ``ref``."""
    ref_grad = _norms(ref.grads[0])
    med = statistics.median(ref_grad.values())
    moving = {k for k, v in ref_grad.items() if v >= STILL_LEAF * med}
    return {
        "loss_gap": _rel_gap(prog.losses, ref.losses),
        "val_loss_gap": _rel_gap(prog.val_losses, ref.val_losses),
        "grad_gap": max(max(_leaf_gaps(_norms(p), _norms(r)))
                        for p, r in zip(prog.grads, ref.grads)),
        "change_gap": max(max(_leaf_gaps(_norms(p), _norms(r), moving))
                          for p, r in zip(prog.steps, ref.steps)),
    }


def detail(prog, ref) -> dict:
    """Each step's and each leaf's gap, for the look behind a number."""
    def leaves(p, r):
        med = statistics.median(r.values())
        return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in r}

    def steps(p, r):
        return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p, r)]

    return {"loss": steps(prog.losses, ref.losses),
            "val_loss": steps(prog.val_losses, ref.val_losses),
            "grad": [leaves(_norms(p), _norms(r))
                     for p, r in zip(prog.grads, ref.grads)],
            "change": [leaves(_norms(p), _norms(r))
                       for p, r in zip(prog.steps, ref.steps)],
            "ref_grad_norm": _norms(ref.grads[0]),
            "ref_step_norm": [_norms(r) for r in ref.steps]}


def judge(values: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, dict]]:
    """``(correct, {name: {"value", "limit"}})``; a number without a
    limit, or a limit without a number, is not correct."""
    checks = {k: {"value": values.get(k), "limit": limits.get(k)}
              for k in sorted(set(values) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None
             and c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
