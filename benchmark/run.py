"""One run of one benchmark cell, as the check calls it:

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

It sets the cell up (weights and traffic from the seed, every shape warmed),
measures for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics)
or traces a short window (``--trace 1``: its per-layer metrics), holds what
the timed path produced to the plain reference, and prints one JSON line
last on standard output. The program's own output goes to standard error.
It needs as many CUDA cards as the cell asks for and never falls back to
the CPU; it fails, printing no result, when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "dlrm_yx_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``dlrm_yx_tpu_torch`` is not ``dlrm_yx_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def result_line(cell, outcome, trace: bool, reader_of, device_info: dict) -> dict:
    """The result's JSON object; the numbers compared come last."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader_of(m["name"])(outcome.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": outcome.correct and outcome.failed == 0, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": dict(device_info)}
    if trace and outcome.trace is not None:
        out["device"].update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
        out["breakdown"] = outcome.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return out


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device, **kw):
    """(bench, cell, outcome) of one run; ``device`` "cuda" on the card; a
    cell on several cards runs in ``benchmark.mesh`` (``kw``: its options)."""
    from benchmark.common import Bench

    bench = Bench(Path(root))
    cell = bench.cell(workload)
    mode = importlib.import_module("benchmark.mesh" if cell.chips > 1 else f"benchmark.{cell.mode}")
    return bench, cell, mode.run(cell, seed, seconds, trace, device, **kw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # compiled bytecode of the modules a run imports (torch's among them) kept
    # in the checkout, also where the environment says not to write it, so
    # that only a checkout's first run compiles them
    sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / "build" / "pycache")
    sys.dont_write_bytecode = False

    from benchmark.common import Bench

    cell = Bench().cell(args.workload)

    import torch

    # one host thread for torch's own operations, as the port's launcher
    # gives each rank (parallel/multihost.spawn_local)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        bench, cell, outcome = run_cell(Bench().root, args.workload, args.seed, args.seconds,
                                        bool(args.trace), "cuda")
        found = forbidden_modules()
        if found:
            print(f"benchmark: JAX or the JAX package was loaded: {found}", file=sys.stderr)
            return 3
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips, "memory_peak_bytes": int(outcome.peak_bytes)}
        line = result_line(cell, outcome, bool(args.trace), bench.reader, device)
        for k, c in line["checks"].items():
            print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
