"""Serving cells: the port's captured eval step (``make_eval_step``) in a
closed loop of one client: each query is one call on a host batch, and its
predictions are copied to the host before the next query is handed off.

Set-up draws the weights on the card from the seed and the mix's pool of
distinct queries, and warms the step on the query shape (eager, capture,
replay). The window hands off queries, cycling the pool, until its time is
up. A sample of the pool's queries drawn from the seed is kept as served
and held to the reference once the program's state is freed.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from benchmark import check, reference
from benchmark.common import Outcome, model_shape, program_config
from benchmark.draw import stream_seed
from benchmark.generate import make_batches
from benchmark.trace import traced
from benchmark.train import stage, sync
from benchmark.weights import model_params

SAMPLE_KEY = 3_000_017
WARM_CALLS = 3


class Serving:
    def __init__(self, cell, seed: int, device):
        from dlrm_yx_tpu_torch.data.batch import Batch
        from dlrm_yx_tpu_torch.train.train_step import make_eval_step

        t0 = time.perf_counter()
        self.device, self.seed, self.cell = torch.device(device), seed, cell
        self.shape = shape = model_shape(cell.config)
        _, cfg = program_config(cell.config)
        self.query = int(cell.mix["query_samples"])
        self.pool = make_batches(cell.mix, shape["raw_rows"], shape["cap"], self.query,
                                 int(cell.mix["pool"]), seed)
        self.host = [Batch(*b) for b in self.pool]
        rng = np.random.default_rng(stream_seed(seed, SAMPLE_KEY))
        self.sample = sorted(rng.choice(len(self.pool), int(cell.mix["checked_queries"]),
                                        replace=False).tolist())
        stage(t0, "traffic drawn")
        self.params = model_params(cfg, seed, self.device)
        stage(t0, "weights drawn")
        self.step = make_eval_step(cfg, self.device)
        for _ in range(WARM_CALLS):
            self.step(self.params, self.host[0])[0].cpu()
            stage(t0, "a warm-up query")
        sync(self.device)
        self.setup_s = time.perf_counter() - t0
        self.kept = {}
        self.failed = 0

    def loop(self, deadline=None, calls=None):
        """Queries until the host clock passes ``deadline`` or ``calls`` are
        done; returns each query's seconds from hand-off to predictions."""
        lat, j, n = [], 0, len(self.host)
        while (calls is None or j < calls) and (deadline is None
                                                or time.perf_counter() < deadline):
            q = j % n
            t0 = time.perf_counter()
            preds, _ = self.step(self.params, self.host[q])
            p = preds.float().cpu().numpy()
            lat.append(time.perf_counter() - t0)
            if not np.isfinite(p).all():
                self.failed += 1
            if q not in self.kept:
                self.kept[q] = p
            j += 1
        return lat

    def free(self) -> None:
        del self.params, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def served_and_reference(self, precision="f32"):
        """(served predictions, the reference's) of the sampled queries; a
        sampled query that was never served reads as NaN."""
        reference.exact_matmul()
        want = reference.predictions(self.shape, self.seed, [self.pool[q] for q in self.sample],
                                     self.device, precision)
        got = [self.kept.get(q, np.full(self.query, np.nan, np.float32)) for q in self.sample]
        return got, want

    def numbers(self) -> dict:
        return check.serve_numbers(*self.served_and_reference())


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    sv = Serving(cell, seed, device)
    info = {"mode": "serve", "shape": sv.shape, "chips": cell.chips,
            "query_samples": sv.query}
    sync(sv.device)
    if sv.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(sv.device)
    if trace:
        calls = int(cell.mix["trace_queries"])
        lat, summary = traced(lambda: sv.loop(calls=calls), sv.device)
        info.update(trace=summary, examples=len(lat) * sv.query, calls=len(lat))
        e2e = {}
    else:
        t0 = time.perf_counter()
        lat = sv.loop(deadline=t0 + seconds)
        sync(sv.device)
        e2e = {"serve_examples_per_s": len(lat) * sv.query / (time.perf_counter() - t0),
               "serve_p95_ms": 1e3 * statistics.quantiles(lat, n=100)[94]}
        summary = None
    peak = torch.cuda.max_memory_allocated(sv.device) if sv.device.type == "cuda" else 0
    e2e.update(setup_s=sv.setup_s, peak_mem_gib=peak / 2**30)
    sv.free()
    return Outcome(e2e=e2e, attempted=len(lat), failed=sv.failed,
                   checks=check.with_limits(sv.numbers(), cell.limits), peak_bytes=peak,
                   trace=summary, run=info)
