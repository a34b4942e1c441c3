"""The port's hybrid (whole-table sharded) steps in a gloo world of 2 CPU
ranks (mesh 1 x 2) against the JAX package's ``HybridRunner`` on the same
mesh shape, every case of ``torch_hybrid_cases``; a world of one against
the port's single-device step; the batch check.

(Meshes 2 x 1 and 2 x 2: ``test_torch_hybrid_mesh.py``.)
"""

import pytest
import torch

from dlrm_yx_tpu.parallel.hybrid import HybridRunner as JaxRunner
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner
from dlrm_yx_tpu_torch.train.train_step import make_eval_step, make_train_step
from torch_hybrid_cases import (
    CASES,
    CONFIG,
    PATCH,
    SEED,
    batches,
    check_world_case,
    mesh_cases,
    world_runner,
)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return world_runner(tmp_path_factory)


@pytest.mark.parametrize("mesh,name", mesh_cases((1, 2)))
def test_hybrid_world_matches_jax(monkeypatch, worlds, mesh, name):
    check_world_case(monkeypatch, worlds(mesh), mesh, name)


@pytest.mark.parametrize("optname", ["sgd", "adagrad", "rwsadagrad"])
def test_world_of_one_equals_the_single_device_step(monkeypatch, optname):
    """At mesh 1 x 1 (no process group) the hybrid step is the port's
    single-device step, bit for bit: the same draws, the same routes."""
    import dlrm_yx_tpu_torch.optim.optimizer as port_opt

    for name, value in PATCH.items():
        monkeypatch.setattr(port_opt, name, value)
    cfg = DLRMConfig.build(**CONFIG, sparse_update_impl="pallas")
    opt = OptConfig(optname, 0.1)
    case = CASES["rwsadagrad"]
    bs = batches(cfg.emb_rows, case)
    params = init_dlrm(cfg, seed=SEED, device="cpu")
    state = init_opt_state(opt, params, model_groups(cfg))
    step = make_train_step(cfg, opt, device="cpu")
    want = [float(step(params, state, b, i)[2]) for i, b in enumerate(bs)]
    runner = HybridRunner(cfg, opt, 1, 1, seed=SEED, device="cpu")
    got = [float(runner.train_step(runner.params, runner.opt_state, runner.prepare_batch(b),
                                   i)[2]) for i, b in enumerate(bs)]
    assert got == want
    single = runner.single_device_params(runner.params)
    for a, b in zip(single["emb"], params["emb"]):
        assert torch.equal(a, b)
    preds, _ = runner.eval_step(runner.params, runner.prepare_batch(bs[0]))
    want_preds, _ = make_eval_step(cfg, device="cpu")(params, bs[0])
    assert torch.equal(preds, want_preds)


def test_batch_the_mesh_does_not_divide_raises_as_in_jax():
    """A batch of 30 on a 2 x 2 mesh, or of 16 on a 1 x 3 mesh: both
    packages raise the same ValueError."""
    from types import SimpleNamespace

    from dlrm_yx_tpu.data.batch import Batch as JaxBatch
    from dlrm_yx_tpu_torch.parallel.hybrid import prepare_batch
    from dlrm_yx_tpu_torch.parallel.plan import make_plan

    cfg = DLRMConfig.build(**CONFIG)
    for (data, model), bsz in (((2, 2), 30), ((1, 3), 16)):
        b = batches(cfg.emb_rows, dict(CASES["sgd"], batch=bsz), n=1)[0]
        mesh = SimpleNamespace(shape={"data": data, "model": model}, d=0, m=0)
        with pytest.raises(ValueError) as got:
            prepare_batch(make_plan(cfg, model, "greedy"), mesh, b)
        jax_runner = JaxRunner.__new__(JaxRunner)
        jax_runner.mesh = SimpleNamespace(shape={"data": data, "model": model})
        with pytest.raises(ValueError) as want:
            jax_runner._prepare_one(JaxBatch(*b))
        assert str(got.value) == str(want.value)


def test_overlap_check_reads_the_exchange_around_the_bottom_mlp(tmp_path):
    """``parallel.overlap.check_a2a_overlap`` on a profiler trace of one
    eager hybrid step: the all-to-all issued before the bottom MLP's first
    GEMM, waited on after its last; and a trace whose wait comes first
    reads as not overlapped."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from dlrm_yx_tpu_torch.parallel.overlap import check_a2a_overlap

    cfg = DLRMConfig.build(**CONFIG)
    runner = HybridRunner(cfg, OptConfig("sgd", 0.1), 1, 1, device="cpu")
    b = runner.prepare_batch(batches(cfg.emb_rows, CASES["sgd"])[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.train_step(runner.params, runner.opt_state, b, 0)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    got = check_a2a_overlap(path)
    assert got == {"issued": True, "bottom_mlp_gemms": len(CONFIG["ln_bot"]) - 1,
                   "issued_before": True, "waited_after": True, "overlapped": True,
                   "a2a_streams": None, "gemm_streams": None,
                   "device_a2a_us": None, "device_overlap_us": None}
    with open(path) as f:
        trace = json.load(f)
    for e in trace["traceEvents"]:
        if e.get("name") == "alltoall_wait":
            e["ts"] = 0.0  # the wait before everything
    assert check_a2a_overlap(trace)["overlapped"] is False


@pytest.mark.parametrize("a2a_kernel, stream, both_us", [
    ((5.0, 45.0), 20, 25.0),   # on NCCL's stream, beside both GEMMs
    ((5.0, 14.0), 7, 0.0),     # a blocking exchange: done before the first GEMM
])
def test_overlap_check_reads_the_device_side(a2a_kernel, stream, both_us):
    """The device side of ``check_a2a_overlap``: the work launched inside the
    exchange's issue against the bottom MLP's GEMM kernels, matched to their
    launches by correlation id. The host order reads the same in both
    traces; only the device intervals tell a blocking exchange apart."""
    from dlrm_yx_tpu_torch.parallel.overlap import check_a2a_overlap

    def x(cat, name, t0, t1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0, "args": args}

    trace = {"traceEvents": [
        x("user_annotation", "alltoall_fwd", 0, 10),
        x("cuda_driver", "cuLaunchKernelEx", 2, 3, correlation=1),
        x("user_annotation", "bottom_mlp", 10, 50),
        x("cpu_op", "aten::addmm", 12, 20),
        x("cuda_runtime", "cudaLaunchKernel", 13, 14, correlation=2),
        x("cpu_op", "aten::addmm", 22, 30),
        x("cuda_runtime", "cudaLaunchKernel", 23, 24, correlation=3),
        x("user_annotation", "alltoall_wait", 50, 60),
        x("kernel", "ncclDevKernel_SendRecv", *a2a_kernel, stream=stream, correlation=1),
        x("kernel", "gemm", 15, 25, stream=7, correlation=2),
        x("kernel", "gemm", 30, 50, stream=7, correlation=3),
        x("kernel", "elementwise", 0, 60, stream=7, correlation=4),  # launched elsewhere
    ]}
    got = check_a2a_overlap(trace)
    assert got == {"issued": True, "bottom_mlp_gemms": 2, "issued_before": True,
                   "waited_after": True, "overlapped": True, "a2a_streams": [stream],
                   "gemm_streams": [7], "device_a2a_us": a2a_kernel[1] - a2a_kernel[0],
                   "device_overlap_us": both_us}
