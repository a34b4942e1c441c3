"""Training cells: the port's ``Trainer.fit`` as the CLI builds it, fed host
batches from the mix's pool until the window closes.

Set-up draws the pool and the weights (on the card, from the seed), builds
the Trainer with the CLI's settings for the configuration's flags (the
duplicate-density hint measured on the first batch, as ``cli._run`` does)
and drives its first steps through ``fit`` and the window's own feed: one
single step (the state after it gives the first gradient), then the first
WARM_DISPATCHES dispatches of ``steps_per_dispatch`` steps, which the
window's dispatch takes to warm up: its eager run, its capture and a
replay. The window feeds whole dispatches until its time is up and ends
when ``fit`` has returned and the card has synchronised. Every one of the
checked steps is held to the reference once the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from benchmark import check, reference
from benchmark.common import Outcome, model_shape, program_config, trainer_settings
from benchmark.generate import batch_at, make_batches
from benchmark.trace import traced
from benchmark.weights import model_params, table_places

# the window's dispatch before the window: eager warm-up, capture, replay
WARM_DISPATCHES = 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stage(t0: float, what: str) -> None:
    """A set-up stage's end, in seconds since set-up began, on standard error."""
    print(f"set-up: {what} at {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


class Feed:
    """A zero-argument factory of the host batches ``fit`` trains on: the
    feed's batches ``batch_of(k)`` from ``k = start`` on, in whole dispatches
    of ``group``, until ``deadline`` (host clock) or ``dispatches``
    dispatches. ``count`` holds the batches yielded once ``fit`` has
    returned."""

    def __init__(self, batch_of, start, group, deadline=None, dispatches=None):
        self.batch_of, self.start, self.group = batch_of, start, group
        self.deadline, self.dispatches = deadline, dispatches
        self.count = 0

    def __call__(self):
        self.count = 0
        while True:
            if self.count % self.group == 0 and (
                    (self.deadline is not None and time.perf_counter() >= self.deadline)
                    or (self.dispatches is not None
                        and self.count >= self.dispatches * self.group)):
                return
            yield self.batch_of(self.start + self.count)
            self.count += 1

    def steps(self):
        """The feed's batch numbers ``k`` that ``fit`` trained on."""
        return range(self.start, self.start + self.count)


def build_trainer(cfg, args, seed, device):
    """The Trainer of the CLI's settings, its weights drawn by
    ``weights.model_params`` in place of the port's host draw."""
    import dlrm_yx_tpu_torch.train.trainer as trainer_mod

    opt, lr_policy, tcfg = trainer_settings(args)
    real = trainer_mod.init_dlrm
    trainer_mod.init_dlrm = lambda config, seed=0, device=None, _s=seed: model_params(
        config, _s, device)
    try:
        return trainer_mod.Trainer(cfg, opt, tcfg, lr_policy, device=device)
    finally:
        trainer_mod.init_dlrm = real


def checked_steps(msteps: int) -> int:
    """The steps that set-up checks: one single step, then WARM_DISPATCHES
    dispatches of ``msteps``."""
    return 1 + WARM_DISPATCHES * msteps


def configured_msteps(conf: dict) -> int:
    """The steps a dispatch that the Trainer picks for a configuration."""
    from dlrm_yx_tpu_torch.train.trainer import _auto_steps_per_dispatch

    args, _ = program_config(conf)
    return _auto_steps_per_dispatch(trainer_settings(args)[2])


class Training:
    """The cell's Trainer on one card through its checked steps, which warm
    the window's dispatch up; ``benchmark.mesh.MeshTraining`` builds a rank
    of a mesh in its place. ``norms``: the program's leaf norms of the
    checked steps, by leaf number (``reference.leaf_names``), for the
    leaves this process holds."""

    def __init__(self, cell, seed: int, device):
        from dlrm_yx_tpu_torch import cli
        from dlrm_yx_tpu_torch.data.batch import Batch

        t0 = time.perf_counter()
        self.device, self.seed, self.cell = torch.device(device), seed, cell
        self.shape = shape = model_shape(cell.config)
        args, cfg = program_config(cell.config)
        self.pool = make_batches(cell.mix, shape["raw_rows"], shape["cap"], shape["batch"],
                                 int(cell.mix["pool"]), seed)
        stage(t0, "traffic drawn")
        self.host = [Batch(*b) for b in self.pool]
        self.batch_of = lambda k: Batch(*batch_at(cell.mix, self.pool, k, seed))
        if cfg.sparse_update_impl in ("pallas", "stream") and cfg.dup_density_hint <= 0:
            hint = cli._measure_dup_density(cfg, self.host)
            if hint is not None:
                cfg = dataclasses.replace(cfg, dup_density_hint=hint)
        self.trainer = trainer = self.build(cfg, args)
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
        first = self.pool[:self.checked]
        self.uniq = [torch.unique(torch.as_tensor(np.concatenate(
            [b[1][t].reshape(-1) for b in first])).long()) for t in range(len(shape["rows"]))]
        self.places = self.table_places()
        p0 = self.leaves()
        trainer.fit(self.host[:1])
        p1 = self.leaves()
        stage(t0, "first step")
        self.next = 1
        self.fit_dispatches(WARM_DISPATCHES)
        sync(self.device)
        pn = self.leaves()
        stage(t0, "window's dispatch warmed: eager, captured, replayed")
        self.step_losses = torch.cat([x.reshape(-1) for x in self.losses]).tolist()
        if len(self.step_losses) != self.checked:
            raise RuntimeError(f"{len(self.step_losses)} losses of {self.checked} checked steps")
        grad, change = check.leaf_norms({"p0": p0, "p1": p1, "pn": pn},
                                        reference.lr_at(0, shape["lr"]))
        n_dense = 2 * (len(shape["ln_bot"]) + len(shape["ln_top"]) - 2)
        held = list(range(n_dense)) + [n_dense + t for t in sorted(self.places)]
        self.norms = {"grad": dict(zip(held, grad)), "change": dict(zip(held, change))}
        del p0, p1, pn
        sync(self.device)
        self.setup_s = time.perf_counter() - t0

    def build(self, cfg, args):
        return build_trainer(cfg, args, self.seed, self.device)

    def table_places(self) -> dict:
        """table id -> (its store in the params, its first row there)."""
        return {t: (lambda p, gi=gi: p["emb"][gi], off)
                for t, (gi, off) in table_places(self.trainer.groups).items()}

    def leaves(self) -> list:
        """Copies of the towers and of the held tables' touched rows."""
        params = self.trainer.params
        out = [p.detach().float().clone() for k in ("bot", "top") for layer in params[k]
               for p in layer]
        for t in sorted(self.places):
            store_of, off = self.places[t]
            store = store_of(params)
            out.append(store.index_select(0, self.uniq[t].to(store.device) + off).float())
        return out

    def _recording(self, step):
        def recorded(*a):
            out = step(*a)
            self.losses.append(out[2])
            return out
        return recorded

    def fit_dispatches(self, n=None, deadline=None) -> Feed:
        """``fit`` over the feed from the next batch on: ``n`` dispatches, or
        whole dispatches until ``deadline``."""
        feed = Feed(self.batch_of, self.next, self.trainer.msteps, deadline=deadline,
                    dispatches=n)
        self.trainer.fit(feed)
        self.next += feed.count
        return feed

    def start_window(self) -> None:
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.losses.clear()

    def failed_steps(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.cat([x.reshape(-1) for x in self.losses]))).sum())

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def free(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, **kw) -> dict:
        return reference.train_steps(self.shape, self.seed, self.pool[:self.checked],
                                     self.device, **kw)

    def reference_norms(self) -> dict:
        reference.exact_matmul()
        return check.reference_norms(self.reference(), reference.lr_at(0, self.shape["lr"]))

    def numbers(self, ref_norms=None) -> dict:
        """The program's checked steps against the reference (after ``free``)."""
        return check.program_numbers(self.step_losses, [self.norms],
                                     ref_norms or self.reference_norms())


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    tr = Training(cell, seed, device)
    info = {"mode": "train", "shape": tr.shape, "chips": cell.chips}
    tr.start_window()
    if trace:
        feed, summary = traced(lambda: tr.fit_dispatches(int(cell.mix["trace_dispatches"])),
                               tr.device)
        info.update(trace=summary, examples=feed.count * tr.shape["batch"], steps=feed.count,
                    batches=[tr.pool[k % len(tr.pool)] for k in feed.steps()])
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
