"""The port's spans and counters (dlrm_yx_tpu_torch/utils/profiling.py) and
where they sit: ``Trainer.fit``'s feed, ``GraphStep``'s copies and replay,
``sparse_update``'s routes, and the operator's ``--enable-profiling``
exporter.

A span is a profiler range that costs one flag check when no profiler is
recording. Counters count per thread, read the kernel wrappers' launches
where they are, and a captured step counts its body once per replay. The
card-only case at the end captures a real step; the CPU cases drive the
same capture logic with a stand-in graph. This file imports no JAX: on the
card, ``python -m pytest --noconftest tests/test_torch_tracing.py``.
"""

import contextlib
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dlrm_yx_tpu_torch.optim.optimizer as port_opt
import dlrm_yx_tpu_torch.utils.profiling as profiling
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.data.batch import Batch, stack_batches
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
from dlrm_yx_tpu_torch.ops.fused_interaction import fused_interaction
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.train.capture import GraphStep, launch_counters
from dlrm_yx_tpu_torch.train.train_step import make_eval_step, make_multistep_train_step
from dlrm_yx_tpu_torch.train.trainer import Trainer, TrainerConfig

# big tables of 3000 and 3200 rows, small ones of 40 and 60: two groups
TWO_GROUPS = dict(emb_rows=(40, 3000, 60, 3200), ln_bot=(4, 16, 16), ln_top=(32, 1),
                  emb_split_threshold=100, loss="bce", sparse_update_impl="pallas")
# a step's routes with the kernel gates open: the big group's store by K2,
# the small group's by the dense branch and K3
ROUTES = {"sparse_update.overwrite": 8, "sparse_update.dense_k3": 8}


@pytest.fixture
def kernel_routes(monkeypatch):
    for name in ("PALLAS_MIN_STORE_BYTES", "ACC_KERNEL_MIN_BYTES"):
        monkeypatch.setattr(port_opt, name, 0)


def _batches(rows, n, b=16, seed=0):
    r = np.random.RandomState(seed)
    return [Batch(r.rand(b, 4).astype(np.float32),
                  np.stack([r.randint(0, m, (b, 1)) for m in rows]).astype(np.int32),
                  np.ones((len(rows), b, 1), np.float32),
                  (r.rand(b, 1) > 0.5).astype(np.float32)) for _ in range(n)]


def _routes(counts):
    return {k: v for k, v in counts.items() if k.startswith("sparse_update.")}


def _recorded(fn, all_threads=False):
    """(fn(), the events of a CPU profiler session over it): the calling
    thread's ranges with their arguments, or every thread's ranges (torch
    2.13 records no arguments then)."""
    kw = profiling._all_threads() if all_threads else {"record_shapes": True}
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn()
    return out, prof.events()


def _spans(events, name):
    return sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)


def _req(e):
    return (e.kwinputs or {}).get("req")


# ---------------------------------------------------------------- spans


def test_phase_scope_records_a_range_with_its_req_under_a_profiler():
    def work():
        with profiling.phase_scope("tracing.outer", 7):
            with profiling.phase_scope("tracing.inner"):
                torch.ones(4).sum()

    _, events = _recorded(work)
    outer, inner = _spans(events, "tracing.outer"), _spans(events, "tracing.inner")
    assert len(outer) == len(inner) == 1
    assert _req(outer[0]) == 7 and _req(inner[0]) is None
    assert outer[0].time_range.start <= inner[0].time_range.start
    assert inner[0].time_range.end <= outer[0].time_range.end
    assert {"tracing.outer", "tracing.inner"} <= profiling.span_names()


def test_phase_scope_opens_no_range_without_a_profiler(monkeypatch):
    def opened(*a, **k):
        raise AssertionError("a range was opened with no profiler recording")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", opened)
    monkeypatch.setattr(profiling, "record_function", opened)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.phase_scope("tracing.off", 3):
        pass
    assert profiling.phase_scope("tracing.off") is profiling.phase_scope("tracing.other", 1)


def test_phase_scope_falls_back_to_record_function(monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", None)

    def work():
        with profiling.phase_scope("tracing.fallback", 5):
            torch.ones(2).sum()

    _, events = _recorded(work)
    assert len(_spans(events, "tracing.fallback")) == 1


# ------------------------------------------------------------- counters


def test_counters_read_the_launches_and_sum_the_threads(monkeypatch):
    monkeypatch.setattr(fused_interaction, "launches", fused_interaction.launches + 5)
    before = profiling.counters()
    assert before["launch.fused_interaction"] == fused_interaction.launches
    assert set(launch_counters()) == {k[len("launch."):] for k in before
                                      if k.startswith("launch.")}
    # the launches are read where they are: no thread's store holds them
    assert not any(k.startswith("launch.") for c in profiling._stores for k in c)
    profiling.count("tracing.test", 2)
    worker = threading.Thread(target=profiling.count, args=("tracing.test", 3))
    worker.start()
    worker.join()
    fused_interaction.launches += 1
    moved = profiling.counter_deltas(before, profiling.counters())
    assert moved == {"tracing.test": 5, "launch.fused_interaction": 1}


def test_counters_lose_no_count_across_threads():
    """Eight threads count while another takes snapshots, with the
    interpreter switching threads often: every count arrives."""
    import sys

    before = profiling.counters().get("tracing.stress", 0)
    done = threading.Event()
    seen = []

    def snapshots():
        while not done.is_set():
            seen.append(profiling.counters().get("tracing.stress", 0))

    def counting():
        for _ in range(5000):
            profiling.count("tracing.stress")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=snapshots)
        reader.start()
        workers = [threading.Thread(target=counting) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        done.set()
        reader.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not reader.is_alive() and not any(w.is_alive() for w in workers)
    assert profiling.counters()["tracing.stress"] - before == 8 * 5000
    assert seen == sorted(seen) and all(before <= v <= before + 40000 for v in seen)


# ------------------------------------------------------ Trainer.fit


@pytest.mark.parametrize("prefetch", [2, 0])
def test_fit_spans_share_a_dispatch_req_and_count_what_ran(kernel_routes, prefetch):
    cfg = DLRMConfig.build(**TWO_GROUPS)
    tcfg = TrainerConfig(print_freq=4, seed=3, steps_per_dispatch=2, prefetch_depth=prefetch)
    tr = Trainer(cfg, OptConfig("rwsadagrad", lr=0.05), tcfg, device="cpu")
    batches = _batches(cfg.emb_rows, 8)
    before = profiling.counters()
    _, events = _recorded(lambda: tr.fit(batches))
    moved = profiling.counter_deltas(before, profiling.counters())

    dispatches = _spans(events, "fit.dispatch")
    assert [_req(e) for e in dispatches] == [0, 2, 4, 6]
    waits = _spans(events, "fit.wait_batch")
    # one wait a dispatch, and the last one finds the feed ended
    assert [_req(e) for e in waits] == [0, 2, 4, 6, 8]
    # the session records the calling thread's ranges: the prefetch thread's
    # stages show only in a session of every thread, below
    assert [_req(e) for e in _spans(events, "fit.stage")] == ([] if prefetch else [0, 2, 4, 6])
    assert [_req(e) for e in _spans(events, "fit.drain")] == [2, 6]
    copies = _spans(events, "step.copy_in")
    assert len(copies) == 4
    for d, c in zip(dispatches, copies):
        assert d.time_range.start <= c.time_range.start <= c.time_range.end \
            <= d.time_range.end
        assert _req(c) == _req(d) and c.thread == d.thread

    assert moved["feed.batches"] == 4
    assert moved.get("feed.empty", 0) <= 4 and (prefetch or "feed.empty" not in moved)
    # the CPU runs the bodies eagerly: no graph was warmed, captured or replayed
    assert not any(k.startswith("graph.") for k in moved)
    routes = _routes(moved)
    assert sum(routes.values()) == 8 * len(model_groups(cfg))
    assert routes == ROUTES

    if profiling._all_threads():
        _, events = _recorded(lambda: tr.fit(batches), all_threads=True)
        stages = _spans(events, "fit.stage")
        assert len(stages) == 4
        main = {e.thread for e in _spans(events, "fit.dispatch")}
        assert len(main) == 1 and ({e.thread for e in stages} == main) == (prefetch == 0)


# ------------------------------------------------ the capture, stood in


class _StandInGraph:
    """A CUDA graph's stand-in: the capture runs the body (as an eager call
    would), a replay runs nothing; the counting around them is the port's."""

    def replay(self):
        pass


@contextlib.contextmanager
def _stand_in_capture(graph, capture_error_mode=None):
    yield


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(GraphStep, "_warm_up", lambda self, args: self.body(*args))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)


def test_a_captured_step_counts_its_body_once_a_replay(kernel_routes, stand_in_graphs):
    cfg = DLRMConfig.build(**TWO_GROUPS)
    opt = OptConfig("rwsadagrad", lr=0.05)
    params = init_dlrm(cfg, seed=3, device="cpu")
    state = init_opt_state(opt, params, model_groups(cfg))
    step = make_multistep_train_step(cfg, opt, 2, device="cpu")
    gs = step.graph_step
    gs.capture = True
    batches = _batches(cfg.emb_rows, 8)

    def run():
        for j in range(0, 8, 2):
            step(params, state, stack_batches(batches[j:j + 2]), j)

    before = profiling.counters()
    _, events = _recorded(run)
    moved = profiling.counter_deltas(before, profiling.counters())
    assert {k: moved.get(k, 0) for k in ("graph.warm", "graph.capture", "graph.replay")} == {
        "graph.warm": 1, "graph.capture": 1, "graph.replay": 3}
    assert gs.replays() == 3
    # warm-up, then three replays: 4 dispatches of 2 steps, two groups a step
    assert _routes(moved) == ROUTES
    assert [_req(e) for e in _spans(events, "step.copy_in")] == [0, 2, 4, 6]
    assert [_req(e) for e in _spans(events, "step.warm")] == [0]
    assert [_req(e) for e in _spans(events, "step.capture")] == [2]
    assert [_req(e) for e in _spans(events, "step.replay")] == [2, 4, 6]
    assert [_req(e) for e in _spans(events, "step.copy_out")] == [2, 4, 6]


def test_an_eval_step_names_its_spans_by_call(stand_in_graphs):
    cfg = DLRMConfig.build(**TWO_GROUPS)
    params = init_dlrm(cfg, seed=3, device="cpu")
    step = make_eval_step(cfg, "cpu")
    step.graph_step.capture = True
    b = _batches(cfg.emb_rows, 1)[0]
    _, events = _recorded(lambda: [step(params, b) for _ in range(4)])
    assert [_req(e) for e in _spans(events, "step.copy_in")] == [1, 2, 3, 4]
    assert [_req(e) for e in _spans(events, "step.replay")] == [2, 3, 4]


# ------------------------------------------------ the operator's trace


def test_trace_writes_the_counters_and_records_a_worker_threads_span(tmp_path):
    def worker():
        with profiling.phase_scope("tracing.worker", 11):
            torch.ones(3).sum()

    with profiling.trace(str(tmp_path)):
        profiling.count("tracing.exported", 4)
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    with open(tmp_path / profiling.COUNTERS_FILE) as f:
        assert json.load(f) == {"tracing.exported": 4}
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    if profiling._all_threads():
        assert "tracing.worker" in names


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_capture_counts_the_routes_once_a_replay(cuda_device, kernel_routes):
    """A real capture: the body's route counts taken back, then added per
    replay, equal to the eager steps' counts."""
    cfg = DLRMConfig.build(**TWO_GROUPS)
    opt = OptConfig("rwsadagrad", lr=0.05)
    # 16 samples a batch, as on the CPU: the big group's 32 ids a step keep it
    # off the dense branch (64 would take it there)
    batches = _batches(cfg.emb_rows, 8)

    def counted(capture):
        params = init_dlrm(cfg, seed=3, device=cuda_device)
        state = init_opt_state(opt, params, model_groups(cfg))
        step = make_multistep_train_step(cfg, opt, 2, device=cuda_device, capture=capture)
        before = profiling.counters()
        for j in range(0, 8, 2):
            step(params, state, stack_batches(batches[j:j + 2]), j)
        torch.cuda.synchronize(cuda_device)
        return profiling.counter_deltas(before, profiling.counters())

    eager, captured = counted(False), counted(True)
    assert {k: captured.get(k, 0) for k in ("graph.warm", "graph.capture", "graph.replay")} == {
        "graph.warm": 1, "graph.capture": 1, "graph.replay": 3}
    assert _routes(captured) == _routes(eager) == ROUTES
    launches = {k: v for k, v in eager.items() if k.startswith("launch.")}
    assert launches and {k: captured.get(k) for k in launches} == launches
