"""DLRM-DCNv2 training cells: the port's ``Trainer.fit`` as the CLI builds it
from the configuration's flags (the ``dcn`` interaction, fixed multi-hot
bags, RWSAdagrad with ``--exact-row-momentum``), fed host batches in the
bag layout from the mix's pool until the window closes.

As ``benchmark.train`` does, set-up draws the pool (on the run's device,
held on the host) and the weights (the cross layers by
``reference_dcn.draw_cross``), builds the Trainer, and
drives one single step and then WARM_DISPATCHES dispatches through
``fit`` and the window's own feed; every one of these checked steps is
held to ``reference_dcn`` once the program's state is freed. The numbers:

- ``grad_gap``: each leaf's first gradient as the optimizer got it, worked
  out from the state around the first step (under Adagrad, row-wise on the
  tables, ``g = (p0 - p1) / lr * (sqrt(a1) + eps)``, ``a1`` the
  accumulator, a table's row momentum, after the step), against the
  reference's exact first gradient, the worst leaf: a tower's or cross
  layer's leaf by the norm of the difference over the larger of its
  reference norm and the median dense leaf's; a table by the median over
  its rows of each row's difference over the row's reference norm. The
  vectors and not their norms: Adagrad's first step moves every entry by
  about the learning rate whatever its gradient, so a gradient of another
  direction keeps its norm. The median row and not the table's norm: a
  table's hot rows, summed over thousands of occurrences, outweigh its
  many rows of a few, which a fault that drops or doubles occurrences
  moves most;
- ``change_gap``: each leaf's change over the checked steps, by norms, the
  worst leaf, as ``benchmark.check`` takes it;
- ``loss_gap``: each checked step's loss against the reference's, and
  ``first_loss_gap``, the first step's alone (the forward from the same
  weights), read but left out of the limits: in bf16 the first steps'
  losses swing (to ~38 at the second step, under Adagrad's first steps of
  the learning rate), and the program's swings depart from the f32
  reference's as far as the control's do (in f32 compute they agree to
  3e-4); the first step's loss, a mean over the batch, averages both
  precisions' rounding away, so there too the program's gap and the
  control's overlap.

Leaves: the towers' and the cross layers' weights and biases, and each
table's rows that the first checked step touches.

The readers get ``run["mode"] == "train"`` (``idle_share.train`` reads the
window), ``run["bench_mode"] == "train_dcn"`` (the DLRM-DCNv2 readers), the
window's counter deltas (``run["counters"]``: ``utils.profiling``'s) and
each traced step's bag items (``run["step_items"]``:
``counts_dcn.step_items``).

The limits' readings, one JSON line a seed (with each side's loss gap
step by step, ``loss_steps``) and the summary last, as
``benchmark.calibrate`` prints them for the other training cells:

    python3 -m benchmark.train_dcn --workload NAME --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import calibrate, check, counts_dcn, reference_dcn
from benchmark.common import Bench, Outcome, program_config, trainer_settings
from benchmark.draw import stream_seed
from benchmark.generate import batch_at
from benchmark.reference import exact_matmul
from benchmark.trace import traced
from benchmark.train import WARM_DISPATCHES, Training, checked_steps, stage, sync
from benchmark.weights import model_params

TRAFFIC_KEY = 2_000_039


def power_ids(gen, raw_rows: int, cap: int, shape, alpha: float) -> torch.Tensor:
    """Ids of one table on the generator's device: ``generate._power_ids``'
    law (rank r drawn with density ~ r^-alpha over the table's raw rows,
    then ``id % cap``) in float64, drawn by ``gen``. int32 of ``shape``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=gen.device)
    r = (1.0 - u * (1.0 - float(raw_rows) ** (1.0 - alpha))) ** (1.0 / (1.0 - alpha))
    return ((r.long() - 1).clamp_(max=raw_rows - 1) % cap).to(torch.int32)


def make_bag_batches(mix: dict, shape: dict, n: int, seed: int, device="cpu"):
    """``n`` distinct batches in the bag layout for ``seed``, drawn on
    ``device`` by one seeded generator (the same seed and kind of device
    give the same batches) and held on the host: each of table t's
    ``hotness[t]`` ids a sample drawn on its own from the mix's power law
    over the table's raw rows, then ``% cap``; dense features
    log1p(Poisson); labels Bernoulli. ``(dense [B, 13], ids [S, B, 1] int32,
    weights ones [S, 1, 1] (a bag is unweighted; not read), labels [B, 1])``."""
    if mix["ids"]["law"] != "power" or mix["dense"]["law"] != "poisson_log1p":
        raise ValueError("the bag traffic draws power-law ids and log1p(Poisson) features")
    if list(mix["hotness"]) != list(shape["hotness"]):
        raise ValueError(f"the mix's hotness {mix['hotness']} is not the model's "
                         f"{shape['hotness']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, TRAFFIC_KEY))
    b = shape["batch"]
    ids = torch.empty((n, sum(shape["hotness"]), b), dtype=torch.int32)
    s = 0
    for raw, h in zip(shape["raw_rows"], shape["hotness"]):
        draws = power_ids(gen, raw, min(raw, shape["cap"]), (n, h, b), float(mix["ids"]["alpha"]))
        ids[:, s:s + h] = draws.cpu()
        s += h
        del draws
    rate = torch.full((n, b, int(mix["dense"]["features"])), float(mix["dense"]["mean"]),
                      device=device)
    dense = torch.log1p(torch.poisson(rate, generator=gen)).cpu().numpy()
    labels = (torch.rand((n, b, 1), generator=gen, device=device)
              < float(mix["labels"]["positive_share"])).float().cpu().numpy()
    ids = ids.numpy()
    ones = np.ones((ids.shape[1], 1, 1), np.float32)
    return [(dense[i], ids[i, :, :, None], ones, labels[i]) for i in range(n)]


def build_trainer(cfg, args, seed, device):
    """The Trainer of the CLI's settings, its weights drawn from the seed:
    ``weights.model_params``' towers and tables, and the cross layers."""
    import dlrm_yx_tpu_torch.train.trainer as trainer_mod

    opt, lr_policy, tcfg = trainer_settings(args)

    def params(config, seed=0, device=None, _s=seed):
        p = model_params(config, _s, device)
        p["dcn"] = reference_dcn.draw_cross(_s, config.ln_top[0], config.dcn_low_rank_dim,
                                            config.dcn_num_layers, device)
        return p

    real = trainer_mod.init_dlrm
    trainer_mod.init_dlrm = params
    try:
        return trainer_mod.Trainer(cfg, opt, tcfg, lr_policy, device=device)
    finally:
        trainer_mod.init_dlrm = real


def first_gradients(p0, p1, a1, lr, eps):
    """Adagrad's first gradient of each leaf from the state around its
    first step (a table's row momentum broadcast over its rows)."""
    return [(x - y) / lr * ((a if a.dim() == x.dim() else a[:, None]).sqrt() + eps)
            for x, y, a in zip(p0, p1, a1)]


def loss_gaps(losses, want):
    """Each step's |loss - reference loss| / |reference loss|."""
    return [abs(a - b) / abs(b) for a, b in zip(losses, want)]


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def change_norms(p0, pn):
    return [_norm(z - x) for x, z in zip(p0, pn)]


def row_gap(got, want) -> float:
    """The median over a table's rows of |got - want| / |want| by row."""
    d = torch.linalg.vector_norm((got.to(want.device) - want).double(), dim=1)
    w = torch.linalg.vector_norm(want.double(), dim=1)
    return float((d / w.clamp_min(1e-30)).median())


def gradient_gap(got, want, n_dense: int) -> float:
    """The worst leaf: a dense leaf's |got - want| / max(|want|, the median
    dense leaf's |want|), a table's ``row_gap`` (the leaves after the first
    ``n_dense``)."""
    norms = [_norm(w) for w in want[:n_dense]]
    med = statistics.median(norms)
    dense = [_norm(g.to(w.device) - w) / max(n, med) for g, w, n in zip(got, want, norms)]
    return max(dense + [row_gap(g, w) for g, w in zip(got[n_dense:], want[n_dense:])])


class DcnTraining(Training):
    """The cell's Trainer on one card through its checked steps; the feed,
    the window and the frees are ``benchmark.train.Training``'s."""

    def __init__(self, cell, seed: int, device):
        from dlrm_yx_tpu_torch import cli
        from dlrm_yx_tpu_torch.data.batch import Batch

        t0 = time.perf_counter()
        self.device, self.seed, self.cell = torch.device(device), seed, cell
        # the program's reading of the flags first: one that lacks the model
        # stops here, before any draw
        args, cfg = program_config(cell.config)
        self.shape = shape = reference_dcn.model_shape(cell.config)
        self.pool = make_bag_batches(cell.mix, shape, int(cell.mix["pool"]), seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # the draw's blocks, before the tables
        stage(t0, "traffic drawn")
        self.host = [Batch(*b) for b in self.pool]
        self.batch_of = lambda k: Batch(*batch_at(cell.mix, self.pool, k, seed))
        if cfg.dup_density_hint <= 0:
            hint = cli._measure_dup_density(cfg, self.host)
            if hint is not None:
                cfg = dataclasses.replace(cfg, dup_density_hint=hint)
        self.trainer = trainer = build_trainer(cfg, args, seed, self.device)
        stage(t0, "weights drawn, Trainer built")
        self.losses = []
        for name in ("train_step", "multi_step"):
            step = getattr(trainer, name)
            if step is not None:
                setattr(trainer, name, self._recording(step))
        self.checked = checked_steps(trainer.msteps)
        if len(self.pool) < self.checked:
            raise ValueError(f"a pool of {len(self.pool)} batches holds fewer than the "
                             f"{self.checked} distinct batches that set-up checks")
        self.compared = [torch.unique(i) for i in
                         reference_dcn.table_ids(self.pool[:1], shape, self.device)]
        self.places = {t: (gi, off) for gi, g in enumerate(trainer.groups)
                       for t, off in zip(g.table_ids, g.row_offsets)}
        p0, _ = self.leaves()
        trainer.fit(self.host[:1])
        p1, a1 = self.leaves()
        stage(t0, "first step")
        self.next = 1
        self.fit_dispatches(WARM_DISPATCHES)
        sync(self.device)
        pn, _ = self.leaves()
        stage(t0, "window's dispatch warmed: eager, captured, replayed")
        self.step_losses = torch.cat([x.reshape(-1) for x in self.losses]).tolist()
        if len(self.step_losses) != self.checked:
            raise RuntimeError(f"{len(self.step_losses)} losses of {self.checked} checked steps")
        self.grads = [g.cpu() for g in first_gradients(p0, p1, a1, shape["lr"], shape["eps"])]
        self.changes = change_norms(p0, pn)
        del p0, p1, a1, pn
        sync(self.device)
        self.setup_s = time.perf_counter() - t0

    def leaves(self):
        """(values, accumulators): copies of the towers' and the cross
        layers' leaves and of the compared table rows, and of their Adagrad
        sums (a table's row momentum)."""
        params, state = self.trainer.params, self.trainer.opt_state

        def dense(tree):
            return [p.detach().float().clone() for k in ("bot", "dcn", "top")
                    for layer in tree[k] for p in layer]

        acc_tree = {"bot": state["dense"]["bot"], "dcn": state["dcn"],
                    "top": state["dense"]["top"]}
        values, accs = dense(params), dense(acc_tree)
        for t, rows in enumerate(self.compared):
            gi, off = self.places[t]
            at = rows + off
            values.append(params["emb"][gi].index_select(0, at).float())
            accs.append(state["emb"][gi].index_select(0, at).float())
        return values, accs

    def reference(self, **kw) -> dict:
        return reference_dcn.train_steps(self.shape, self.seed, self.pool[:self.checked],
                                         self.device, compared=self.compared, **kw)

    def reference_norms(self, ref=None) -> dict:
        """What the comparison takes of a reference run: its losses, its
        exact first gradients and their norms, its changes' norms."""
        if ref is None:
            exact_matmul()
            ref = self.reference()
        return {"losses": list(ref["losses"]), "g1": ref["g1"],
                "exact": [_norm(g) for g in ref["g1"]], "change": change_norms(ref["p0"], ref["pn"])}

    def numbers(self, ref_norms=None, side=None) -> dict:
        """The program's checked steps (or ``side``, a reference run put in
        its place) against the reference (after ``free``)."""
        r = ref_norms or self.reference_norms()
        if side is None:
            losses, grads, changes = self.step_losses, self.grads, self.changes
        else:
            losses = side["losses"]
            grads = first_gradients(side["p0"], side["p1"], side["a1"], self.shape["lr"],
                                    self.shape["eps"])
            changes = change_norms(side["p0"], side["pn"])
        med = statistics.median(r["exact"])
        moved = [i for i, g in enumerate(r["exact"]) if g >= check.STILL_LEAF * med]
        n_dense = len(r["g1"]) - len(self.compared)
        gaps = loss_gaps(losses, r["losses"])
        return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
                "grad_gap": gradient_gap(grads, r["g1"], n_dense),
                "change_gap": check.worst_leaf_gap(changes, r["change"], moved)}


def readings(cell, seed: int, device, steps=None) -> dict:
    """``benchmark.calibrate``'s readings of one seed: the program, the
    control (the reference in float8 products) and the half-batch fault,
    each against the reference. ``steps``, a dict, gets each side's loss
    gap step by step."""
    tr = DcnTraining(cell, seed, device)
    tr.free()
    exact_matmul()
    ref = tr.reference_norms()
    control = tr.reference(precision="fp8")
    half = tr.reference(half_batch=True)
    if steps is not None:
        steps.update(program=loss_gaps(tr.step_losses, ref["losses"]),
                     control=loss_gaps(control["losses"], ref["losses"]),
                     half_batch=loss_gaps(half["losses"], ref["losses"]))
    return {"program": tr.numbers(ref), "control": tr.numbers(ref, control),
            "half_batch": tr.numbers(ref, half)}


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    from dlrm_yx_tpu_torch.utils.profiling import counter_deltas, counters

    tr = DcnTraining(cell, seed, device)
    info = {"mode": "train", "bench_mode": "train_dcn", "shape": tr.shape, "chips": cell.chips}
    tr.start_window()
    if trace:
        before = counters()
        feed, summary = traced(lambda: tr.fit_dispatches(int(cell.mix["trace_dispatches"])),
                               tr.device)
        items = {}
        for k in feed.steps():
            i = k % len(tr.pool)
            if i not in items:
                items[i] = counts_dcn.step_items(tr.pool[i][1], tr.shape)
        info.update(trace=summary, counters=counter_deltas(before, counters()),
                    examples=feed.count * tr.shape["batch"], steps=feed.count,
                    step_items=[items[k % len(tr.pool)] for k in feed.steps()])
        e2e = {}
    else:
        t0 = time.perf_counter()
        feed = tr.fit_dispatches(deadline=t0 + seconds)
        sync(tr.device)
        e2e = {"train_examples_per_s": feed.count * tr.shape["batch"] / (time.perf_counter() - t0)}
        summary = None
    peak = tr.peak_bytes()
    e2e.update(setup_s=tr.setup_s, peak_mem_gib=peak / 2**30)
    attempted, failed = feed.count, tr.failed_steps()
    tr.free()
    return Outcome(e2e=e2e, attempted=attempted, failed=failed,
                   checks=check.with_limits(tr.numbers(), cell.limits), peak_bytes=peak,
                   trace=summary, run=info)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The readings of a DLRM-DCNv2 cell's limits")
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
