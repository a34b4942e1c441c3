"""Pre-generated "processed dataset": table configs and saved batches.

The port's own copy of ``dlrm_yx_tpu/data/processed.py`` (numpy only),
after the reference's standalone generator ``gen_synthetic_data.py``
(random ``table_configs.json`` with per-table row, dim and pooling factor,
and pre-generated batches) and its consumer ``ProcessedDataset``
(``dlrm_data_pytorch.py:952-1028``, the ``--load-processed`` flow with
per-table dims). It writes and reads the same two files as the JAX
package, from the same draws:

  * ``table_configs.json``: {"tables": [{"index", "row", "dim",
    "pooling_factor"}, ...]}, the reference's schema;
  * ``data.npz``: fixed-shape padded batches (dense [N, B, m], indices
    [N, T, B, Lmax], weights, labels).

``generate_processed_data`` redraws a lookup until its ``pf`` ids are all
distinct, as the reference does: about exp(pf^2 / 2n) tries for a table
of n rows, so a pooling factor near n (the generator CLI's default range
reaches 500 on tables of 500 rows) may never finish, in both packages.

    python -m dlrm_yx_tpu_torch.data.processed --out-dir DIR \
        --pooling-factor-range 1,32
    python -m dlrm_yx_tpu_torch.cli --load-processed DIR \
        --arch-mlp-bot 512-512-64 --arch-sparse-feature-size 64 ...
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from dlrm_yx_tpu_torch.data.batch import Batch


def gen_table_configs(
    num_tables: int,
    row_range: Tuple[int, int] = (500, 10000),
    dim_choices: Tuple[int, ...] = (64, 128, 256, 512),
    pooling_range: Tuple[int, int] = (1, 32),
    rng: Optional[np.random.RandomState] = None,
) -> dict:
    rng = rng or np.random.RandomState(0)
    rows = rng.randint(row_range[0], row_range[1], num_tables)
    pooling = rng.randint(pooling_range[0], pooling_range[1], num_tables)
    dims = rng.choice(np.asarray(dim_choices), num_tables)
    return {
        "tables": [
            {
                "index": i,
                "row": int(rows[i]),
                "dim": int(dims[i]),
                "pooling_factor": int(pooling[i]),
            }
            for i in range(num_tables)
        ]
    }


def generate_processed_data(
    table_configs: dict,
    m_den: int,
    num_batches: int,
    mini_batch_size: int,
    round_targets: bool = False,
    log_transform_dense: bool = True,
    seed: int = 0,
) -> List[Batch]:
    """Uniform indices with exactly pooling_factor unique ids per lookup
    (the reference's generate_uniform_input_batch in gen_synthetic_data.py,
    which re-draws until the unique count matches); dense features get the
    log(x+1) transform the generator applies (gen_synthetic_data.py:82)."""
    rng = np.random.RandomState(seed)
    tables = table_configs["tables"]
    t = len(tables)
    l_max = max(tc["pooling_factor"] for tc in tables)
    b = mini_batch_size
    batches = []
    for _ in range(num_batches):
        dense = rng.rand(b, m_den).astype(np.float32)
        if log_transform_dense:
            dense = np.log(dense + 1.0)
        indices = np.zeros((t, b, l_max), dtype=np.int32)
        weights = np.zeros((t, b, l_max), dtype=np.float32)
        for k, tc in enumerate(tables):
            size, pf = tc["row"], min(tc["pooling_factor"], tc["row"])
            for i in range(b):
                while True:
                    r = rng.random_sample(pf)
                    group = np.unique(np.round(r * (size - 1)).astype(np.int64))
                    if group.size == pf:
                        break
                indices[k, i, :pf] = group
                weights[k, i, :pf] = 1.0
        labels = rng.rand(b, 1).astype(np.float32)
        if round_targets:
            labels = np.round(labels).astype(np.float32)
        batches.append(Batch(dense, indices, weights, labels))
    return batches


def save_processed(path_dir: str, table_configs: dict, batches: List[Batch]) -> None:
    os.makedirs(path_dir, exist_ok=True)
    with open(os.path.join(path_dir, "table_configs.json"), "w") as f:
        json.dump(table_configs, f)
    np.savez_compressed(
        os.path.join(path_dir, "data.npz"),
        dense=np.stack([b.dense for b in batches]),
        indices=np.stack([b.indices for b in batches]),
        weights=np.stack([b.weights for b in batches]),
        labels=np.stack([b.labels for b in batches]),
    )


def load_table_configs(path_dir: str) -> dict:
    """Read table_configs.json (tables sorted by index) — shared by the
    CLI's arch wiring and the batch loader."""
    with open(os.path.join(path_dir, "table_configs.json")) as f:
        tc = json.load(f)
    tc["tables"] = sorted(tc["tables"], key=lambda c: c["index"])
    return tc


def load_processed(path_dir: str) -> Tuple[dict, List[Batch]]:
    """Returns (table_configs, batches). Use table config rows/dims to build
    the model (the reference wires these into ln_emb/emb dims at
    dlrm_s_pytorch.py:1405-1441)."""
    tc = load_table_configs(path_dir)
    with np.load(os.path.join(path_dir, "data.npz")) as d:
        n = d["dense"].shape[0]
        batches = [
            Batch(d["dense"][i], d["indices"][i], d["weights"][i], d["labels"][i])
            for i in range(n)
        ]
    return tc, batches


def main(argv=None):
    """CLI mirroring the reference's processed-dataset generator
    (``gen_synthetic_data.py:113-158``): random table
    configs + pre-generated batches saved for --load-processed."""
    import argparse

    p = argparse.ArgumentParser(description="Generate a processed dataset")
    p.add_argument("--T", type=int, default=12)
    p.add_argument("--m-den", type=int, default=512)
    p.add_argument("--num-batches", type=int, default=10)
    p.add_argument("--mini-batch-size", type=int, default=2048)
    p.add_argument("--row-range", type=str, default="500,10000")
    p.add_argument("--dim-range", type=str, default="64,128,256,512")
    p.add_argument("--pooling-factor-range", type=str, default="10,500")
    p.add_argument("--out-dir", type=str, default="synthetic")
    p.add_argument("--seed", type=int, default=123)
    args = p.parse_args(argv)

    rows = tuple(int(x) for x in args.row_range.split(","))
    dims = tuple(int(x) for x in args.dim_range.split(","))
    pools = tuple(int(x) for x in args.pooling_factor_range.split(","))
    cfgs = gen_table_configs(
        args.T, row_range=rows, dim_choices=dims, pooling_range=pools,
        rng=np.random.RandomState(args.seed),
    )
    batches = generate_processed_data(
        cfgs, args.m_den, args.num_batches, args.mini_batch_size,
        seed=args.seed + 1,
    )
    save_processed(args.out_dir, cfgs, batches)
    print(f"wrote {args.num_batches} batches x {args.T} tables to {args.out_dir}")


if __name__ == "__main__":
    main()
