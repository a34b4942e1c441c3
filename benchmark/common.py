"""What every cell shares: finding a cell's files by name, the plain reading
of a configuration's flags, and the outcome a mode hands back.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the harness finds

- the configuration at the ``file`` that ``BENCHMARK.json`` gives it,
- the mix at ``benchmark/traffic/<traffic>.json``,
- the limits of the numbers that decide ``correct`` at
  ``benchmark/limits/<workload>.json``,
- each per-layer metric's reader at ``benchmark/metrics/<metric>.py``,

all under the checkout's root, so a new cell, mix or metric is new files.
The mix's ``mode`` names the module that runs it (``benchmark/<mode>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: str
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def mode(self) -> str:
        return self.mix["mode"]


class Bench:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _json(self, rel: str) -> dict:
        with open(self.root / rel) as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        w = cells[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        e2e = [m for m in self.spec["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in self.spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                    config=self._json(conf["file"]), traffic=w["traffic"],
                    mix=self._json(f"benchmark/traffic/{w['traffic']}.json"),
                    limits=self._json(f"benchmark/limits/{name}.json"),
                    end_to_end=e2e, per_layer=layer, root=self.root)

    def reader(self, metric: str):
        """The ``read(run)`` function of a per-layer metric's module."""
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def flag_values(flags) -> Dict[str, str]:
    """``--name=value`` flags as a dict (a bare ``--name`` reads "1")."""
    out = {}
    for a in flags:
        k, _, v = a.partition("=")
        out[k] = v if _ else "1"
    return out


def dashes(s: str) -> List[int]:
    return [int(x) for x in s.split("-")]


def model_shape(conf: dict) -> dict:
    """The model as the reference and the counts read it, from the
    configuration's flags and raw table rows, without the program."""
    f = flag_values(conf["flags"])
    raw = [int(r) for r in conf["raw_rows"]]
    cap = int(f.get("--max-ind-range", "0"))
    dim = int(f["--arch-sparse-feature-size"])
    ln_bot = dashes(f["--arch-mlp-bot"])
    feats = len(raw) + 1
    top = dashes(f["--arch-mlp-top"])
    return {
        "raw_rows": raw,
        "cap": cap if cap > 0 else max(raw),
        "rows": [min(r, cap) if cap > 0 else r for r in raw],
        "dim": dim,
        "ln_bot": ln_bot,
        "ln_top": [dim + feats * (feats - 1) // 2] + top,
        "batch": int(f["--mini-batch-size"]),
        "interaction": f.get("--arch-interaction-op", "dot"),
        "loss": f.get("--loss-function", "mse"),
        "compute_dtype": f.get("--compute-dtype", "float32"),
        "split_threshold": int(f.get("--emb-split-threshold",
                                     conf["assumed"]["emb_split_threshold"])),
        "lr": {"base": float(f["--learning-rate"]),
               "warmup": int(f.get("--lr-num-warmup-steps", "0")),
               "decay_start": int(f.get("--lr-decay-start-step", "0")),
               "decay_steps": int(f.get("--lr-num-decay-steps", "0"))},
    }


def program_config(conf: dict):
    """(args, DLRMConfig) as the port's CLI builds them from the
    configuration's flags, the table rows given as the capped raw rows
    (``--arch-embedding-size``), as dataset mode derives them."""
    from dlrm_yx_tpu_torch import cli

    rows = model_shape(conf)["rows"]
    argv = list(conf["flags"]) + ["--arch-embedding-size=" + "-".join(map(str, rows))]
    args = cli.build_parser().parse_args(argv)
    return args, cli.config_from_args(args, argv)


def trainer_settings(args):
    """(OptConfig, LRPolicy or None, TrainerConfig) as the port's CLI builds
    them from its flags (dlrm_yx_tpu_torch/cli.py:676-704, ``_run``)."""
    from dlrm_yx_tpu_torch.optim.lr_policy import LRPolicy
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig
    from dlrm_yx_tpu_torch.train.trainer import TrainerConfig

    opt = OptConfig(name=args.optimizer, lr=args.learning_rate)
    lr_policy = None
    if args.lr_num_warmup_steps or args.lr_num_decay_steps:
        lr_policy = LRPolicy(base_lr=args.learning_rate,
                             num_warmup_steps=args.lr_num_warmup_steps,
                             decay_start_step=args.lr_decay_start_step,
                             num_decay_steps=args.lr_num_decay_steps)
    tcfg = TrainerConfig(
        nepochs=args.nepochs, print_freq=args.print_freq, test_freq=max(args.test_freq, 0),
        mlperf_logging=args.mlperf_logging, mlperf_acc_threshold=args.mlperf_acc_threshold,
        mlperf_auc_threshold=args.mlperf_auc_threshold, save_path=args.save_model,
        load_path=args.load_model, ckpt_backend=args.ckpt_backend,
        tb_logdir=args.tensor_board_filename, seed=args.numpy_rand_seed,
        grad_accum_iter=args.mlperf_grad_accum_iter,
        steps_per_dispatch=args.steps_per_dispatch, prefetch_depth=args.prefetch_depth)
    return opt, lr_policy, tcfg


@dataclasses.dataclass
class Outcome:
    """What one run of a mode measured.

    e2e: end-to-end readings by metric name; checks: each number compared
    for ``correct``, (value, limit); run: what the per-layer readers read
    (``benchmark/metrics``): the traced window's summary and counts."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, tuple]
    peak_bytes: int
    trace: Optional[Any] = None
    run: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v == v and v <= lim for v, lim in self.checks.values())
