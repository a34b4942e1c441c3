"""The readings that the limits of ``benchmark/limits/<workload>.json`` are
set from, for a cell at its own size on the card, one seed after another
in one process:

    python3 -m benchmark.calibrate --workload NAME --seeds 1,2,3

For each seed it prints one JSON line with the numbers of

- ``program``: the timed path against the reference (set-up and the
  checked part of a run, without the measured window): the lower reading;
- ``control``: the reference computed in float8 (e4m3) products, put in the
  program's place: the upper reading;
- ``half_batch`` (training): the reference with the loss taken over half of
  each batch, put in the program's place: a planted fault.

A state left unchanged reads 1 on ``change_gap`` by its definition, and an
altered answer reads its alteration on ``pred_gap``: neither needs a run.
With ``--reference-only`` (a cell across cards, whose program readings come
from its runs) only the control and the planted fault are read, on one
card: they need no program.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark import check, reference
from benchmark.common import Bench


def train_readings(cell, seed, device):
    from benchmark.train import Training

    tr = Training(cell, seed, device)
    tr.free()
    reference.exact_matmul()
    ref = tr.reference()
    lr0 = reference.lr_at(0, tr.shape["lr"])
    return {"program": tr.numbers(check.reference_norms(ref, lr0)),
            "control": check.train_numbers(tr.reference(precision="fp8"), ref, lr0),
            "half_batch": check.train_numbers(tr.reference(half_batch=True), ref, lr0)}


def reference_readings(cell, seed, device):
    """The control and the half-batch fault against the reference, from the
    cell's first batches: no program."""
    from benchmark.common import model_shape
    from benchmark.generate import make_batches
    from benchmark.train import checked_steps, configured_msteps

    shape = model_shape(cell.config)
    pool = make_batches(cell.mix, shape["raw_rows"], shape["cap"], shape["batch"],
                        checked_steps(configured_msteps(cell.config)), seed)
    reference.exact_matmul()
    ref = reference.train_steps(shape, seed, pool, device)
    lr0 = reference.lr_at(0, shape["lr"])
    return {side: check.train_numbers(reference.train_steps(shape, seed, pool, device, **kw),
                                      ref, lr0)
            for side, kw in (("control", {"precision": "fp8"}), ("half_batch",
                                                                 {"half_batch": True}))}


def serve_readings(cell, seed, device):
    from benchmark.serve import Serving

    sv = Serving(cell, seed, device)
    sv.loop(calls=len(sv.host))
    sv.free()
    got, want = sv.served_and_reference()
    control = reference.predictions(sv.shape, sv.seed, [sv.pool[q] for q in sv.sample],
                                    sv.device, "fp8")
    return {"program": check.serve_numbers(got, want),
            "control": check.serve_numbers([c.cpu().numpy() for c in control], want)}


def summary(rows):
    """Per number: the largest program reading and the smallest of each
    other side's."""
    out = {}
    for side in rows[0]:
        pick = max if side == "program" else min
        out[side] = {k: pick(r[side][k] for r in rows) for k in rows[0][side]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--reference-only", action="store_true")
    args = p.parse_args(argv)
    cell = Bench().cell(args.workload)
    readings = (reference_readings if args.reference_only else
                train_readings if cell.mode == "train" else serve_readings)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        with contextlib.redirect_stdout(sys.stderr):
            r = readings(cell, seed, "cuda")
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
