"""Training cells across cards: one process a card, started by the port's
launcher (``parallel.multihost.spawn_local``), each a rank of an NCCL world
(gloo on the CPU) that trains through ``Trainer.fit`` with the runner of the
configuration's mesh flags (``--shard-mode table``: ``HybridRunner``).

Each rank draws only its own tables on its card (the blocks of
``benchmark.draw``, laid out as the runner's plan places them), builds the
Trainer as the CLI does, drives the checked steps as ``benchmark.train`` does,
which warm the window's dispatch. The ranks then agree on a number of
dispatches that lasts ``--seconds`` at the rate of a few timed ones (every
rank has to run as many: each dispatch waits for all of them), and run
them. After the window each rank reports its leaves' norms and frees its
state; rank 0 then runs the reference on the touched rows, drawn again
from the seed. The launching process merges the ranks' reports:

    python3 -m benchmark.mesh --spec SPEC.json     (one rank; set by the launcher)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark import check
from benchmark.common import Bench, Outcome, model_shape, trainer_settings
from benchmark.draw import draw_block, draw_tower, table_blocks
from benchmark.generate import make_batches
from benchmark.trace import TraceSummary, traced
from benchmark.train import Training, sync

RATE_DISPATCHES = 32     # timed dispatches from which the window's count is set
RANK_TIMEOUT_S = 1100.0  # the whole world of ranks, a first run's build included


def shard_params(config, plan, m, seed, device):
    """Model rank ``m``'s hybrid params, drawn on its card: each of its
    tables' draw blocks at the table's place in the big or the small store
    (zero padding), the towers whole. Frozen copy of chip_smoke.py:5062-5138
    (``shard_views`` and ``drawn_shard_params``, the hybrid mode)."""
    from dlrm_yx_tpu_torch.parallel.hybrid import _slot_places

    params = {"emb": torch.zeros((plan.r_big_pad, plan.dim), device=device),
              "emb_small": torch.zeros((plan.r_small_pad, plan.dim), device=device)}
    for pid, (section, off) in _slot_places(plan, m).items():
        t = plan.pseudo_table[pid]
        n = config.emb_rows[t]
        store = params["emb" if section == "big" else "emb_small"]
        for r0, r1 in table_blocks(n):
            store[off + r0: off + r1] = draw_block(seed, t, n, plan.dim, r0, r1, device)
    params.update(bot=draw_tower(seed, 0, config.ln_bot, device),
                  top=draw_tower(seed, 1, config.ln_top, device), vw=None)
    return params


class MeshTraining(Training):
    """One rank's Trainer over the cell's mesh (``HybridRunner``), through its
    first steps; it holds the towers and its own tables."""

    def build(self, cfg, args):
        from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner
        from dlrm_yx_tpu_torch.parallel.plan import make_plan
        from dlrm_yx_tpu_torch.train.trainer import Trainer

        if args.shard_mode != "table" or args.mesh_data != 1:
            raise NotImplementedError("the benchmark runs whole-table (hybrid) meshes of one "
                                      "data rank")
        opt, lr_policy, tcfg = trainer_settings(args)
        plan = make_plan(cfg, args.mesh_model, args.sharder)
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        runner = HybridRunner(cfg, opt, data=1, model=args.mesh_model, sharder=args.sharder,
                              lr_fn=lr_policy, device=self.device,
                              params=shard_params(cfg, plan, rank, self.seed, self.device))
        self.plan, self.m = plan, runner.mesh.m
        return Trainer(cfg, opt, tcfg, lr_policy, runner=runner)

    def table_places(self) -> dict:
        from dlrm_yx_tpu_torch.parallel.hybrid import _slot_places

        return {self.plan.pseudo_table[pid]: (
            lambda p, key="emb" if section == "big" else "emb_small": p[key], off)
            for pid, (section, off) in _slot_places(self.plan, self.m).items()}

    def agreed_dispatches(self, seconds: float) -> int:
        """The dispatches that last ``seconds`` at the slowest rank's rate of
        RATE_DISPATCHES timed ones, the same number on every rank."""
        sync(self.device)
        t0 = time.perf_counter()
        self.fit_dispatches(RATE_DISPATCHES)
        sync(self.device)
        per = torch.tensor([(time.perf_counter() - t0) / RATE_DISPATCHES], device=self.device)
        torch.distributed.all_reduce(per, op=torch.distributed.ReduceOp.MAX)
        return max(1, math.ceil(seconds / float(per)))


def rank_main(argv=None) -> int:
    """One rank: set-up, window, its report, and on rank 0 the reference."""
    p = argparse.ArgumentParser(description="one rank of a benchmark cell across cards")
    p.add_argument("--spec", required=True)
    spec = json.loads(Path(p.parse_args(argv).spec).read_text())
    from dlrm_yx_tpu_torch.parallel.multihost import init_multihost, local_device

    torch.set_num_threads(1)
    with contextlib.redirect_stdout(sys.stderr):
        rank, _ = init_multihost(device=spec["device"])
        device = local_device(spec["device"])
        cell = Bench(Path(spec["root"])).cell(spec["workload"])
        mt = MeshTraining(cell, spec["seed"], device)
        out = {"rank": rank, "setup_s": mt.setup_s, "norms": mt.norms,
               "losses": mt.step_losses}
        if spec["trace"]:
            n = int(cell.mix["trace_dispatches"])
            torch.distributed.barrier()
            mt.start_window()
            feed, summary = traced(lambda: mt.fit_dispatches(n), device)
            out["trace"] = dataclasses.asdict(summary)
            out["batches"] = [k % len(mt.pool) for k in feed.steps()]
        else:
            n = mt.agreed_dispatches(spec["seconds"])
            torch.distributed.barrier()
            mt.start_window()
            t0 = time.perf_counter()
            feed = mt.fit_dispatches(n)
            sync(device)
            out["window_s"] = time.perf_counter() - t0
        out.update(steps=feed.count, failed=mt.failed_steps(), peak_bytes=mt.peak_bytes())
        mt.free()
        torch.distributed.barrier()
        if rank == 0:
            out["reference"] = mt.reference_norms()
        Path(spec["out_dir"], f"rank{rank}.json").write_text(json.dumps(out))
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return 0


def merge(cell, ranks, trace: bool, seed: int) -> Outcome:
    """The launching process's outcome from the ranks' reports."""
    shape = model_shape(cell.config)
    r0 = ranks[0]
    numbers = check.program_numbers(r0["losses"], [r["norms"] for r in ranks], r0["reference"])
    steps = r0["steps"]
    peak = max(r["peak_bytes"] for r in ranks)
    e2e = {"setup_s": max(r["setup_s"] for r in ranks), "peak_mem_gib": peak / 2**30}
    info = {"mode": "train", "shape": shape, "chips": cell.chips, "steps": steps}
    summary = None
    if trace:
        summary = TraceSummary.merged([
            TraceSummary(**{k: v for k, v in r["trace"].items() if k != "ranks"})
            for r in ranks])
        pool = make_batches(cell.mix, shape["raw_rows"], shape["cap"], shape["batch"],
                            int(cell.mix["pool"]), seed)
        info.update(trace=summary, examples=steps * shape["batch"],
                    batches=[pool[i] for i in r0["batches"]])
    else:
        e2e["train_examples_per_s"] = steps * shape["batch"] / max(r["window_s"] for r in ranks)
    return Outcome(e2e=e2e, attempted=steps, failed=max(r["failed"] for r in ranks),
                   checks=check.with_limits(numbers, cell.limits), peak_bytes=peak,
                   trace=summary, run=info)


def run(cell, seed: int, seconds: float, trace: bool, device,
        child=("-m", "benchmark.mesh")) -> Outcome:
    """Start one rank a card (``child``: the rank's command after
    ``python``), wait for all, and merge their reports."""
    from dlrm_yx_tpu_torch.parallel.multihost import spawn_local

    if cell.mode != "train":
        raise NotImplementedError("cells across cards train")
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp, "spec.json")
        spec.write_text(json.dumps({"workload": cell.name, "seed": seed, "seconds": seconds,
                                    "trace": trace, "device": str(device),
                                    "root": str(cell.root), "out_dir": tmp}))
        env = dict(os.environ)
        env["PYTHONPYCACHEPREFIX"] = str(Path(__file__).resolve().parents[1] / "build" / "pycache")
        env.pop("PYTHONDONTWRITEBYTECODE", None)  # as benchmark.run does for itself
        spawn_local(list(child) + ["--spec", str(spec)], cell.chips, timeout=RANK_TIMEOUT_S,
                    env=env)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(cell.chips)]
    return merge(cell, ranks, trace, seed)


if __name__ == "__main__":
    sys.exit(rank_main())
