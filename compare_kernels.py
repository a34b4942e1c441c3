"""Times the port's K1, K5 and K6 kernels of one or more checkouts on one
NVIDIA card, in turns, each against its plain PyTorch version.

    python3 compare_kernels.py [REPO ...]

Each REPO is the root of a checkout of this repository (default: this
one); its ``dlrm_yx_tpu_torch`` builds its own kernels into its own
``build/``. With two checkouts A and B the runs go A, B, B, A, each in a
process of its own, so both are timed on one card in one call. Every run
prints one JSON line (``{"repo": ..., "cases": {name: {"ms", "plain_ms",
"rel_err", ...}}}``) and the script ends with the card's name and power
limit. Cases, at the main path's shapes:

  * K1 at the serving shape (B=2048, S=26, D=128), bf16 and f32 compute;
  * K5 on the reference L=100 benchmark's store (8 x 1M rows x 64 f32)
    with one device batch's sorted occurrences (batch 2048, SGD's
    weights), and on the same batch with every weight-0 id sent to its
    table's row 0, as host batches (``--data-generation random``) pad;
  * K6 on the same store with a batch-4096 device batch's update rows.

Times are CUDA-graph replays of ``REPS`` wrapper calls, median of
``SAMPLES`` replays, CUDA events. Needs a card; exits 1 without one.
"""

import json
import os
import statistics
import subprocess
import sys

REPS, SAMPLES = 5, 15
TOL = {"K1": 1e-5, "K5": 1e-6, "K6": 1e-6}  # max |kernel - plain| / max |plain|


def device_time_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / REPS)
    return statistics.median(times)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def run_one(repo):
    """One checkout's cases, in this process."""
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    from dlrm_yx_tpu_torch.config import DLRMConfig
    from dlrm_yx_tpu_torch.data.synthetic import make_device_random_batches
    from dlrm_yx_tpu_torch.models.dlrm import model_groups
    from dlrm_yx_tpu_torch.ops.embedding import global_row_ids
    from dlrm_yx_tpu_torch.ops.fused_interaction import (
        fused_interaction,
        fused_interaction_reference,
    )
    from dlrm_yx_tpu_torch.ops.stream_update import (
        sorted_stream_add,
        sorted_stream_add_reference,
        sorted_stream_apply,
        sorted_stream_apply_reference,
    )
    from dlrm_yx_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    cases = {}

    def case(name, kernel, plain, fresh, tol):
        got, want = kernel(fresh()), plain(fresh())
        torch.cuda.synchronize()
        err = rel_err(got, want)
        if not err <= tol:
            raise SystemExit(f"{repo} {name}: relative error {err} > {tol}")
        held = fresh()
        cases[name] = {"rel_err": err, "ms": device_time_ms(lambda: kernel(held)),
                       "plain_ms": device_time_ms(lambda: plain(held))}
        return got

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2048, 128, device="cuda", generator=gen)
    ly = torch.randn(2048, 26, 128, device="cuda", generator=gen)
    for name, cdt in (("K1 bf16", torch.bfloat16), ("K1 f32", torch.float32)):
        case(name, lambda _, c=cdt: fused_interaction(x, ly, False, c),
             lambda _, c=cdt: fused_interaction_reference(x, ly, False, c), lambda: None,
             TOL["K1"])
    del x, ly

    rows = [1_000_000] * 8
    cfg = DLRMConfig.build(emb_rows=rows, ln_bot=(512, 512, 64), ln_top=(1024, 1024, 1024, 1))
    (group,) = model_groups(cfg)
    store = torch.rand(group.total_rows, group.dim, device="cuda", generator=gen) - 0.5
    b = make_device_random_batches(rows, 512, 2048, 1, 100, seed=21, device="cuda")[0]
    gidx = global_row_ids(group, b.indices)
    offs = torch.tensor(group.row_offsets, device="cuda", dtype=gidx.dtype)[:, None, None]
    gtab = torch.randn(8 * 2048, 64, device="cuda", generator=gen) * 1e-2
    for name, ids in (("K5 benchmark stream", gidx),
                      ("K5 row-0 padding", torch.where(b.weights != 0, gidx, offs))):
        pos, perm = torch.sort(ids.reshape(-1), stable=True)
        seg = torch.div(perm, 100, rounding_mode="floor").to(torch.int32)
        w = -0.1 * b.weights.reshape(-1)[perm]
        got = case(name, lambda s: sorted_stream_apply(s, pos, seg, w, gtab),
                   lambda s: sorted_stream_apply_reference(s, pos, seg, w, gtab),
                   store.clone, TOL["K5"])
        live_rows = int(torch.unique_consecutive(pos[w != 0]).numel())
        changed = int((got != store).any(dim=1).sum())
        cases[name].update(live_rows=live_rows, changed_rows=changed, k=pos.numel(),
                           row0_run=int((pos == pos[0]).sum()))
        del got
    del gtab
    b = make_device_random_batches(rows, 512, 4096, 1, 100, seed=22, device="cuda")[0]
    pos, _ = torch.sort(global_row_ids(group, b.indices).reshape(-1), stable=True)
    upd = torch.randn(pos.numel(), 64, device="cuda", generator=gen) * 1e-2
    case("K6 batch 4096", lambda s: sorted_stream_add(s, pos, upd),
         lambda s: sorted_stream_add_reference(s, pos, upd), store.clone, TOL["K6"])
    print(json.dumps({"repo": repo, "device": torch.cuda.get_device_name(0), "cases": cases}),
          flush=True)


def main():
    if sys.argv[1:2] == ["--one"]:
        return run_one(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this needs the card", flush=True)
        sys.exit(1)
    repos = sys.argv[1:] or [os.path.dirname(os.path.abspath(__file__))]
    order = repos if len(repos) == 1 else [repos[0], repos[1], repos[1], repos[0]]
    for repo in order:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", repo], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
