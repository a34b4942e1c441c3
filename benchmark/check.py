"""The numbers that decide ``correct``: what the timed path produced against
the plain reference.

Training (set-up's checked steps, through the window's own ``Trainer.fit``
and feed: one single step, then the window's dispatch of 16 steps in its
eager run, its capture and a replay): each step's loss; the norm of each
leaf's first gradient as the optimizer got it, worked out from the state
after one step, (p0 - p1) / lr0, on both sides (a table's update of a row
touched many times rounds occurrence by occurrence, in the program as in
the reference); the norm of each leaf's change over the checked steps,
read before the next one. Both norms are taken by the worst leaf: the gap between the two
sides' norms over the larger of the reference's norm of that leaf and of
the median leaf. A leaf whose reference gradient is under a thousandth of
the median leaf's moves by round-off alone and is left out of the change.
Leaves: each tower's weights and biases, and each table's touched rows.

Serving: the widest gap between a served prediction and the reference's,
over a sample of the window's queries drawn from the seed.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

# a reference gradient under this share of the median leaf's: round-off only
STILL_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def worst_leaf_gap(got, want, keep=None) -> float:
    """max over leaves of |got - want| / max(want, median(want))."""
    med = statistics.median(want)
    idx = range(len(want)) if keep is None else keep
    return max(abs(got[i] - want[i]) / max(want[i], med) for i in idx)


def leaf_norms(side: dict, lr0: float):
    """(first-gradient norms, change norms) of each leaf of ``side``, which
    holds ``p0``, ``p1`` and ``pn`` (leaves in ``reference.leaf_names``
    order)."""
    return ([_norm(a - b) / lr0 for a, b in zip(side["p0"], side["p1"])],
            [_norm(a - b) for a, b in zip(side["pn"], side["p0"])])


def numbers_from_norms(losses, grad, change, ref_losses, ref_grad, ref_change,
                       ref_exact) -> dict:
    """The training numbers from each side's losses and leaf norms;
    ``ref_exact``: the norms of the reference's exact first gradients, which
    pick the leaves that move."""
    med = statistics.median(ref_exact)
    moved = [i for i, g in enumerate(ref_exact) if g >= STILL_LEAF * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_gap": worst_leaf_gap(grad, ref_grad),
            "change_gap": worst_leaf_gap(change, ref_change, moved)}


def reference_norms(ref: dict, lr0: float) -> dict:
    """What the comparison takes of a reference run: losses and norms."""
    grad, change = leaf_norms(ref, lr0)
    return {"losses": list(ref["losses"]), "grad": grad, "change": change,
            "exact": [_norm(g) for g in ref["g1"]]}


def program_numbers(losses, held_norms, ref_norms: dict) -> dict:
    """The training numbers of the program from its losses and the leaf
    norms that each of its processes holds (``held_norms``: dicts of
    ``grad`` and ``change`` by leaf number; a leaf that several hold, as the
    towers on every rank of a mesh, is taken from the first)."""
    n = len(ref_norms["grad"])
    grad, change = {}, {}
    for held in held_norms:
        for i, v in held["grad"].items():
            grad.setdefault(int(i), v)
        for i, v in held["change"].items():
            change.setdefault(int(i), v)
    if sorted(grad) != list(range(n)) or sorted(change) != list(range(n)):
        raise RuntimeError("the program's processes do not hold every leaf once")
    return numbers_from_norms(losses, [grad[i] for i in range(n)],
                              [change[i] for i in range(n)], ref_norms["losses"],
                              ref_norms["grad"], ref_norms["change"], ref_norms["exact"])


def train_numbers(side: dict, ref: dict, lr0: float) -> dict:
    """``side`` (the program, or the reference put in its place) and ``ref``
    each hold ``losses``, ``p0``, ``p1`` and ``pn``; ``ref`` also ``g1``,
    its exact first gradients."""
    grad, change = leaf_norms(side, lr0)
    r = reference_norms(ref, lr0)
    return numbers_from_norms(side["losses"], grad, change, r["losses"], r["grad"],
                              r["change"], r["exact"])


def serve_numbers(got, want) -> dict:
    """got: served predictions (host arrays), want: the reference's."""
    gap = 0.0
    for g, w in zip(got, want):
        g = torch.as_tensor(np.asarray(g, np.float32).reshape(-1)).to(w.device)
        gap = max(gap, float((g.double() - w.double()).abs().max()))
    return {"pred_gap": gap}


def with_limits(numbers: dict, limits: dict) -> dict:
    """name -> (value, limit), for every number the limits file names."""
    return {k: (float(numbers[k]), float(limits[k])) for k in limits}
