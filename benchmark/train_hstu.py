"""HSTU training cells: the port's ``Trainer.fit`` as the CLI builds it from
the configuration's flags (``--model=hstu``: exact row-wise Adagrad on the
item table, AdamW on the dense leaves), fed host batches of jagged user
histories (``data.batch.SeqBatch``) from the mix's pool until the window
closes.

As ``benchmark.train`` does, set-up draws the pool (on the run's device,
held on the host) and the weights (``reference_hstu.draw_items`` and
``draw_dense``), builds the Trainer, and drives one single step and then
WARM_DISPATCHES dispatches through ``fit`` and the window's own feed; every
one of these checked steps is held to ``reference_hstu`` once the
program's state is freed. The numbers:

- ``grad_gap``: each leaf's first gradient as the optimizer got it against
  the reference's exact first gradient, the worst leaf: a dense leaf's
  from AdamW's first moment after the first step (m = (1 - beta1) g; its
  change, about lr * sign(g), tells nothing of g), by the norm of the
  difference over the larger of its reference norm and the median dense
  leaf's; the item table's from the state around the first step under
  row-wise Adagrad (``g = (p0 - p1) / lr * (sqrt(a1) + eps)``), by the
  median over the compared rows of each row's difference over its
  reference norm (``train_dcn.gradient_gap``);
- ``change_gap``: each leaf's change over the checked steps, by norms, the
  worst leaf, as ``benchmark.check`` takes it;
- ``loss_gap``: each checked step's loss against the reference's, and
  ``first_loss_gap``, the first step's alone (the forward from the same
  weights), read but left out of the limits.

Leaves: the positions, each block's W_uvqk, W_o, b_o and bias tables, and
the item table's compared rows: at most COMPARED_ROWS of the rows that the
first checked step touches, drawn from the seed (the copies of every
touched row, about four million of 512 floats, would not fit beside the
table).

``train_examples_per_s`` counts supervised positions (events that have a
next one) trained over the window's seconds.

The readers get ``run["mode"] == "train"`` (``idle_share.train`` reads the
window), ``run["bench_mode"] == "train_hstu"`` (the HSTU readers), the
window's counter deltas (``run["counters"]``), each traced step's
history lengths and supervised positions (``run["step_work"]``) and its
item-table items and distinct rows (``run["step_items"]``,
``counts_hstu.step_items``).

The limits' readings, one JSON line a seed and the summary last, as
``benchmark.calibrate`` prints them for the other training cells:

    python3 -m benchmark.train_hstu --workload NAME --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import calibrate, check, counts_hstu, reference_hstu
from benchmark.common import Bench, Outcome, trainer_settings
from benchmark.draw import DRAW_BLOCK_ROWS, stream_seed
from benchmark.reference import exact_matmul
from benchmark.trace import traced
from benchmark.train import WARM_DISPATCHES, Training, checked_steps, stage, sync
from benchmark.train_dcn import change_norms, gradient_gap, loss_gaps, power_ids

TRAFFIC_KEY = 2_000_041
COMPARED_KEY = 2_000_043
COMPARED_ROWS = 1 << 16


def history_lengths(gen, tokens: int, lo: int, hi: int) -> np.ndarray:
    """Lengths log-uniform on [lo, hi] (floor of exp of a uniform draw on
    [ln lo, ln(hi + 1))), drawn by ``gen`` until they fill ``tokens``, the
    last cut to fit."""
    u = torch.rand(tokens // lo + 1, generator=gen, dtype=torch.float64, device=gen.device)
    n = torch.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo))).long().clamp_(lo, hi)
    n = n.cpu().numpy()
    ends = np.cumsum(n)
    k = int(np.searchsorted(ends, tokens)) + 1
    n = n[:k].copy()
    n[-1] -= int(ends[k - 1]) - tokens
    return n


def make_pool(mix: dict, shape: dict, n: int, seed: int, device="cpu"):
    """``n`` distinct host ``SeqBatch``es for ``seed``: the histories'
    lengths, items, gaps and negatives drawn on ``device`` by one seeded
    generator, laid out by the program's ``data.synthetic.seq_batch``
    (offsets, positives, weights) and ``history_times`` (each history's
    times rise from 0 by its gaps)."""
    from dlrm_yx_tpu_torch.data.synthetic import history_times, seq_batch

    if (mix["ids"]["law"] != "power" or mix["lengths"]["law"] != "log_uniform"
            or mix["gaps"]["law"] != "log_normal" or mix["negatives"]["law"] != "uniform"):
        raise ValueError("the jagged traffic draws power-law items, log-uniform lengths, "
                         "log-normal gaps and uniform negatives")
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, TRAFFIC_KEY))
    t, items = shape["tokens"], shape["items"]
    lo, hi = int(mix["lengths"]["min"]), int(mix["lengths"]["max"])
    if hi > shape["max_len"]:
        raise ValueError(f"histories up to {hi} events for a model of {shape['max_len']}")
    median, sigma = float(mix["gaps"]["median_s"]), float(mix["gaps"]["sigma"])
    pool = []
    for _ in range(n):
        lengths = history_lengths(gen, t, lo, hi)
        ids = power_ids(gen, items, items, (t,), float(mix["ids"]["alpha"])).cpu().numpy()
        z = torch.randn(t, generator=gen, dtype=torch.float64, device=gen.device)
        gaps = torch.exp(math.log(median) + sigma * z).long().cpu().numpy()
        neg = torch.randint(0, items, (t, shape["negatives"]), generator=gen,
                            device=gen.device, dtype=torch.int32).cpu().numpy()
        pool.append(seq_batch(ids, history_times(gaps, lengths), lengths, neg,
                              shape["max_sequences"]))
    return pool


def step_work(batch) -> tuple:
    """(history lengths, supervised positions) of a host batch."""
    return counts_hstu.lengths_of(batch[2]), int(np.asarray(batch[5]).sum())


def first_dense_gradients(m1, beta1: float):
    """AdamW's first moment after its first step is (1 - beta1) g."""
    return [m / (1.0 - beta1) for m in m1]


def first_row_gradients(p0, p1, a1, lr, eps):
    """Row-wise Adagrad's first gradient of rows from the state around its
    first step (a1: the rows' momentum after it)."""
    return (p0 - p1) / lr * (a1.sqrt() + eps)[:, None]


def build_trainer(cfg, opt, tcfg, lr_policy, seed, device):
    """The Trainer of the CLI's settings, its weights drawn from the seed by
    ``reference_hstu``'s draws (the table a block at a time, in place)."""
    import dlrm_yx_tpu_torch.train.trainer as trainer_mod
    from dlrm_yx_tpu_torch.models.hstu import SPARE_ROWS

    def params(config, seed=0, device=None, _s=seed):
        shape_d = {"dim": config.embedding_dim, "max_len": config.max_seq_len,
                   "heads": config.num_heads, "dv": config.linear_dim,
                   "dqk": config.attention_dim, "blocks": config.num_blocks,
                   "time_buckets": config.num_time_buckets}
        n, d = config.num_items, config.embedding_dim
        items = torch.zeros((n + SPARE_ROWS, d), device=device)
        for r0 in range(0, n, DRAW_BLOCK_ROWS):
            r1 = min(n, r0 + DRAW_BLOCK_ROWS)
            items[r0:r1] = reference_hstu.draw_items(_s, n, d, r0, r1, device)
        return {"items": items, **reference_hstu.draw_dense(_s, shape_d, device)}

    real = trainer_mod.init_hstu
    trainer_mod.init_hstu = params
    try:
        return trainer_mod.Trainer(cfg, opt, tcfg, lr_policy, device=device)
    finally:
        trainer_mod.init_hstu = real


class HstuTraining(Training):
    """The cell's Trainer on one card through its checked steps; the feed,
    the window and the frees are ``benchmark.train.Training``'s."""

    def __init__(self, cell, seed: int, device):
        from dlrm_yx_tpu_torch import cli
        from dlrm_yx_tpu_torch.models.dlrm import dense_leaves

        t0 = time.perf_counter()
        self.device, self.seed, self.cell = torch.device(device), seed, cell
        # the program's reading of the flags first: one that lacks the model
        # stops here, before any draw
        args = cli.build_parser().parse_args(cell.config["flags"])
        cfg = cli.config_from_args(args)
        opt, lr_policy, tcfg = trainer_settings(args)
        self.shape = shape = reference_hstu.model_shape(cell.config)
        self.pool = make_pool(cell.mix, shape, int(cell.mix["pool"]), seed, self.device)
        stage(t0, "traffic drawn")
        self.batch_of = lambda k: self.pool[k % len(self.pool)]
        self.trainer = trainer = build_trainer(cfg, opt, tcfg, lr_policy, seed, self.device)
        stage(t0, "weights drawn, Trainer built")
        self.dense_of = dense_leaves
        self.losses = []
        for name in ("train_step", "multi_step"):
            step = getattr(trainer, name)
            if step is not None:
                setattr(trainer, name, self._recording(step))
        self.checked = checked_steps(trainer.msteps)
        if len(self.pool) < self.checked:
            raise ValueError(f"a pool of {len(self.pool)} batches holds fewer than the "
                             f"{self.checked} distinct batches that set-up checks")
        self.compared = compared_rows(self.pool[0], seed, self.device)
        p0, _, _ = self.leaves()
        trainer.fit(self.pool[:1])
        p1, a1, m1 = self.leaves()
        stage(t0, "first step")
        self.next = 1
        self.fit_dispatches(WARM_DISPATCHES)
        sync(self.device)
        pn, _, _ = self.leaves()
        stage(t0, "window's dispatch warmed: eager, captured, replayed")
        self.step_losses = torch.cat([x.reshape(-1) for x in self.losses]).tolist()
        if len(self.step_losses) != self.checked:
            raise RuntimeError(f"{len(self.step_losses)} losses of {self.checked} checked steps")
        n_dense = len(p0) - 1
        self.grads = [g.cpu() for g in first_dense_gradients(m1, shape["betas"][0])]
        self.grads.append(first_row_gradients(p0[-1], p1[-1], a1, shape["lr"],
                                              shape["eps"]).cpu())
        self.changes = change_norms(p0, pn)
        self.n_dense = n_dense
        del p0, p1, a1, m1, pn
        sync(self.device)
        self.setup_s = time.perf_counter() - t0

    def leaves(self):
        """(values, the compared rows' momentum, AdamW's first moments):
        copies of the dense leaves and of the compared table rows."""
        params, state = self.trainer.params, self.trainer.opt_state
        values = [p.detach().float().clone() for p in self.dense_of(params)]
        at = self.compared.to(params["items"].device)
        values.append(params["items"].index_select(0, at).float())
        m1 = [m.detach().clone() for m in self.dense_of(state["adam_m"])]
        return values, state["items"].index_select(0, at).float(), m1

    def reference(self, **kw) -> dict:
        return reference_hstu.train_steps(self.shape, self.seed, self.pool[:self.checked],
                                          self.device, self.compared, **kw)

    def reference_norms(self, ref=None) -> dict:
        if ref is None:
            exact_matmul()
            ref = self.reference()
        return {"losses": list(ref["losses"]), "g1": ref["g1"],
                "exact": [_norm(g) for g in ref["g1"]], "change": change_norms(ref["p0"], ref["pn"])}

    def numbers(self, ref_norms=None, side=None) -> dict:
        """The program's checked steps (or ``side``, a reference run put in
        its place, its first gradients its own exact ones) against the
        reference (after ``free``)."""
        r = ref_norms or self.reference_norms()
        if side is None:
            losses, grads, changes = self.step_losses, self.grads, self.changes
        else:
            losses, grads = side["losses"], side["g1"]
            changes = change_norms(side["p0"], side["pn"])
        med = statistics.median(r["exact"])
        moved = [i for i, g in enumerate(r["exact"]) if g >= check.STILL_LEAF * med]
        gaps = loss_gaps(losses, r["losses"])
        return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
                "grad_gap": gradient_gap(grads, r["g1"], len(r["g1"]) - 1),
                "change_gap": check.worst_leaf_gap(changes, r["change"], moved)}


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def compared_rows(batch, seed: int, device) -> torch.Tensor:
    """Up to COMPARED_ROWS of the distinct items a batch touches (its
    tokens', positives' and negatives'), drawn from the seed, sorted
    (int64 on ``device``)."""
    uniq = torch.unique(reference_hstu.batch_ids(batch, device))
    if uniq.shape[0] <= COMPARED_ROWS:
        return uniq
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, COMPARED_KEY))
    pick = torch.randperm(uniq.shape[0], generator=gen, device=device)[:COMPARED_ROWS]
    return torch.sort(uniq[pick]).values


def readings(cell, seed: int, device, steps=None) -> dict:
    """``benchmark.calibrate``'s readings of one seed: the program, the
    control (the reference in float8 products) and the half-batch fault,
    each against the reference. ``steps``, a dict, gets each side's loss
    gap step by step."""
    tr = HstuTraining(cell, seed, device)
    tr.free()
    exact_matmul()
    ref = tr.reference()
    norms = tr.reference_norms(ref)
    control = tr.reference(precision="fp8")
    half = tr.reference(half_batch=True)
    if steps is not None:
        steps.update(program=loss_gaps(tr.step_losses, norms["losses"]),
                     control=loss_gaps(control["losses"], norms["losses"]),
                     half_batch=loss_gaps(half["losses"], norms["losses"]))
    return {"program": tr.numbers(norms), "control": tr.numbers(norms, control),
            "half_batch": tr.numbers(norms, half)}


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    from dlrm_yx_tpu_torch.utils.profiling import counter_deltas, counters

    tr = HstuTraining(cell, seed, device)
    info = {"mode": "train", "bench_mode": "train_hstu", "shape": tr.shape, "chips": cell.chips}
    tr.start_window()
    if trace:
        before = counters()
        feed, summary = traced(lambda: tr.fit_dispatches(int(cell.mix["trace_dispatches"])),
                               tr.device)
        work = [step_work(tr.pool[k % len(tr.pool)]) for k in feed.steps()]
        items = {}
        for k in feed.steps():
            if k % len(tr.pool) not in items:
                items[k % len(tr.pool)] = counts_hstu.step_items(tr.pool[k % len(tr.pool)])
        info.update(trace=summary, counters=counter_deltas(before, counters()),
                    examples=sum(p for _, p in work), steps=feed.count, step_work=work,
                    step_items=[items[k % len(tr.pool)] for k in feed.steps()])
        e2e = {}
    else:
        t0 = time.perf_counter()
        feed = tr.fit_dispatches(deadline=t0 + seconds)
        sync(tr.device)
        positions = sum(step_work(tr.pool[k % len(tr.pool)])[1] for k in feed.steps())
        e2e = {"train_examples_per_s": positions / (time.perf_counter() - t0)}
        summary = None
    peak = tr.peak_bytes()
    reserved = torch.cuda.memory_reserved(tr.device) if tr.device.type == "cuda" else 0
    print(f"memory: peak allocated {peak / 2**30:.3f} GiB, reserved {reserved / 2**30:.3f} GiB "
          "(the captured step's private pool included)", file=sys.stderr)
    e2e.update(setup_s=tr.setup_s, peak_mem_gib=peak / 2**30)
    attempted, failed = feed.count, tr.failed_steps()
    tr.free()
    return Outcome(e2e=e2e, attempted=attempted, failed=failed,
                   checks=check.with_limits(tr.numbers(), cell.limits), peak_bytes=peak,
                   trace=summary, run=info)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The readings of an HSTU cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    cell = Bench().cell(args.workload)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        steps = {}
        with contextlib.redirect_stdout(sys.stderr):
            r = readings(cell, seed, "cuda", steps)
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed, **r, "loss_steps": steps}),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "summary": calibrate.summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
