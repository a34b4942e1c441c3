"""One rank of a gloo world that runs the port's sharded steps on the CPU.

    python tests/torch_hybrid_worker.py SPEC.json

(RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT set by the launcher,
``dlrm_yx_tpu_torch.parallel.multihost.spawn_local``). SPEC gives the mesh
``[D, M]``, the model (``DLRMConfig.build`` keywords), the batch seed, the
routing constants to patch (``PALLAS_MIN_STORE_BYTES`` ...), the cases and
the output path; a case may bring its own model (``config``). Each case builds its
runner (``mode``: ``table``, the default, a ``HybridRunner``; ``row`` or ``col``, a
``RowShardedRunner`` or ``ColShardedRunner``) from ``seed``, its optimizer
state raised to ``acc0``, and runs its steps on the port's random batches; rank 0 writes, per case, the losses,
every table after the steps (gathered from the model shards and
``extract_tables``; and ``vw`` / ``vw_small`` gathered, ``qr_r``, ``md_proj``
where the model has them) and the eval step's predictions on the first batch to
an npz that the tests hold to the JAX package. This file imports nothing of
JAX: the tests start it as a script, outside pytest.

Case kinds: ``train`` (one step a call), ``multistep`` (the steps in one
call of ``make_multi_step``; its losses also as single steps from the same
start, ``single_losses``) and ``accum`` (``n_accum`` micro-batches a step).
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dlrm_yx_tpu_torch.optim.optimizer as port_opt  # noqa: E402
from dlrm_yx_tpu_torch.config import DLRMConfig  # noqa: E402
from dlrm_yx_tpu_torch.data.batch import stack_batches  # noqa: E402
from dlrm_yx_tpu_torch.data.synthetic import (  # noqa: E402
    RandomDataConfig,
    make_random_batches,
)
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig  # noqa: E402
from dlrm_yx_tpu_torch.parallel.col_sharded import ColShardedRunner  # noqa: E402
from dlrm_yx_tpu_torch.parallel.hybrid import HybridRunner  # noqa: E402
from dlrm_yx_tpu_torch.parallel.multihost import init_multihost  # noqa: E402
from dlrm_yx_tpu_torch.parallel.plan import extract_tables  # noqa: E402
from dlrm_yx_tpu_torch.parallel.row_sharded import RowShardedRunner  # noqa: E402


def batches_of(cfg, case, seed):
    return make_random_batches(RandomDataConfig(
        emb_rows=cfg.emb_rows, m_den=cfg.ln_bot[0], mini_batch_size=case["batch"],
        num_batches=case["steps"] * case.get("n_accum", 1),
        num_indices_per_lookup=case["lookups"], num_indices_per_lookup_fixed=False,
        round_targets=True, seed=seed))


def start(runner, spec):
    """The optimizer state starts at ``acc0`` everywhere (as the JAX side's)."""
    for t in leaves(runner.opt_state):
        t.add_(spec["acc0"])


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return []


def make_runner(case, cfg, opt, kw):
    """The case's runner: ``mode`` table (HybridRunner, the default), row or
    col."""
    mode = case.get("mode", "table")
    if mode == "table":
        return HybridRunner(cfg, opt, **kw)
    cls = RowShardedRunner if mode == "row" else ColShardedRunner
    return cls(cfg, opt, **{k: v for k, v in kw.items() if k != "sharder"})


def tables(runner):
    if not isinstance(runner, HybridRunner):
        return [t.numpy() for t in runner.tables(runner.params)]
    mesh = runner.mesh
    big = mesh.all_gather_model(runner.params["emb"].unsqueeze(0))
    small = mesh.all_gather_model(runner.params["emb_small"].unsqueeze(0))
    return [t.numpy() for t in extract_tables(runner.plan, runner.config, big, small)]


def run_case(spec, case, out):
    data, model = spec["mesh"]
    cfg = DLRMConfig.build(**{**case.get("config", spec["config"]),
                              "sparse_update_impl": case["impl"]})
    opt = OptConfig(case["opt"], case["lr"])
    n_accum = case.get("n_accum", 1)
    kw = dict(data=data, model=model, sharder=case.get("sharder", "greedy"),
              seed=spec["seed"], n_accum=n_accum, device="cpu")
    runner = make_runner(case, cfg, opt, kw)
    start(runner, spec)
    bs = batches_of(cfg, case, spec["batch_seed"])
    name = case["name"]
    if case["kind"] == "multistep":
        step = runner.make_multi_step(case["steps"])
        losses = step(runner.params, runner.opt_state,
                      runner.prepare_batch(stack_batches(bs)), 0)[2]
        single = make_runner(case, cfg, opt, kw)
        start(single, spec)
        out[f"{name}/single_losses"] = np.array(
            [float(single.train_step(single.params, single.opt_state,
                                     single.prepare_batch(b), i)[2])
             for i, b in enumerate(bs)])
        out[f"{name}/single_tables"] = np.concatenate(
            [t.reshape(-1) for t in tables(single)])
    elif case["kind"] == "accum":
        groups = [stack_batches(bs[i:i + n_accum]) for i in range(0, len(bs), n_accum)]
        losses = torch.stack([
            runner.train_step(runner.params, runner.opt_state, runner.prepare_batch(g), i)[2]
            for i, g in enumerate(groups)])
    else:
        losses = torch.stack([
            runner.train_step(runner.params, runner.opt_state, runner.prepare_batch(b), i)[2]
            for i, b in enumerate(bs)])
    out[f"{name}/losses"] = losses.numpy()
    for t, w in enumerate(tables(runner)):
        out[f"{name}/table{t}"] = w
    for key in ("vw", "vw_small"):
        v = runner.params.get(key)
        if v is not None:
            out[f"{name}/{key}"] = (runner.mesh.all_gather_model(v.unsqueeze(0))
                                    if key in runner.sharded_keys else v).numpy()
    if "qr_r" in runner.params:
        out[f"{name}/qr_r"] = runner.params["qr_r"].numpy()
    for i, w in enumerate(runner.params.get("md_proj", [])):
        out[f"{name}/md_proj{i}"] = w.numpy()
    preds, loss = runner.eval_step(runner.params, runner.prepare_batch(bs[0]))
    out[f"{name}/preds"] = preds.numpy()
    out[f"{name}/eval_loss"] = loss.numpy()


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    for name, value in spec.get("patch", {}).items():
        setattr(port_opt, name, value)
    rank, _ = init_multihost(device="cpu")
    out = {}
    for case in spec["cases"]:
        run_case(spec, case, out)
    if rank == 0:
        np.savez(spec["out"], **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
