"""Offline embedding-table visualization and analysis.

The port of ``dlrm_yx_tpu/tools/visualize.py`` (the reference's
``tools/visualize.py``), reading the port's checkpoints: 2-D projections of
trained embedding tables (PCA always, t-SNE from sklearn, UMAP when
importable), categorical-frequency analysis of the input data
(visualize.py:232-316 there) and density clustering of the rows (HDBSCAN
when importable, else sklearn's DBSCAN; visualize.py:414-500 there). Host
code: it needs numpy, and sklearn and matplotlib where it projects and
plots.

Usage:
    python -m dlrm_yx_tpu_torch.tools.visualize \
        --load-model /path/to/ckpt_dir \
        --arch-embedding-size 1000-1000-1000 --arch-sparse-feature-size 16 \
        --arch-mlp-bot 13-512-256-64-16 --arch-mlp-top 512-256-1 \
        --output-dir ./viz [--max-rows 2000] [--tsne] [--umap] [--cluster] \
        [--freq-npz indices.npz]

Plots are written as PNGs (matplotlib Agg); projections also as .npz for
downstream analysis.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def pca_2d(x: np.ndarray) -> np.ndarray:
    """Plain numpy 2-component PCA (always available)."""
    mu = x.mean(axis=0, keepdims=True)
    xc = x - mu
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    return xc @ vt[:2].T


def tsne_2d(x: np.ndarray, seed: int = 0) -> np.ndarray:
    from sklearn.manifold import TSNE

    perplexity = min(30.0, max(2.0, (x.shape[0] - 1) / 3.0))
    return TSNE(
        n_components=2, random_state=seed, init="pca", perplexity=perplexity
    ).fit_transform(x)


def umap_2d(x: np.ndarray, seed: int = 0) -> Optional[np.ndarray]:
    """UMAP projection (reference visualize.py:82-140); None if the umap
    package is absent from the image."""
    try:
        import umap  # noqa: F401 (optional dependency)
    except ImportError:
        return None
    return umap.UMAP(n_components=2, random_state=seed).fit_transform(x)


def cluster_labels(x: np.ndarray) -> np.ndarray:
    """Density clustering of rows: HDBSCAN if importable (reference
    visualize.py:414-500), else sklearn DBSCAN on standardized data."""
    try:
        import hdbscan

        return hdbscan.HDBSCAN(min_cluster_size=15).fit_predict(x)
    except ImportError:
        from sklearn.cluster import DBSCAN
        from sklearn.preprocessing import StandardScaler

        xs = StandardScaler().fit_transform(x)
        return DBSCAN(eps=0.5 * np.sqrt(x.shape[1]), min_samples=10).fit_predict(xs)


# ---------------------------------------------------------------------------
# frequency analysis
# ---------------------------------------------------------------------------

def collect_frequencies_from_loader(
    batches, emb_rows, max_batches: int = 0
) -> List[np.ndarray]:
    """Accumulate per-table index frequencies from ACTUAL loader batches
    (any loader yielding the port's Batches with [T, B, L] indices) — the
    reference drives its categorical analysis from the training data the
    same way (tools/visualize.py:232-316)."""
    freqs = [np.zeros(n, np.int64) for n in emb_rows]
    for bi, b in enumerate(batches):
        if max_batches and bi >= max_batches:
            break
        idx = torch.as_tensor(b.indices).cpu().numpy()
        w = torch.as_tensor(b.weights).cpu().numpy()
        for t, n in enumerate(emb_rows):
            live = idx[t][w[t] > 0]
            if live.size:
                freqs[t] += np.bincount(
                    np.clip(live.ravel(), 0, n - 1), minlength=n
                )
    return freqs


def per_feature_analysis(
    tables: List[np.ndarray],
    freqs: List[np.ndarray],
    output_dir: str,
) -> Dict[str, str]:
    """The reference's analyse_categorical_counts twin
    (tools/visualize.py:259-316): per categorical variable, a two-panel
    figure of access counts (log scale) and embedding row L2 norms."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    out = {}
    for t, (table, f) in enumerate(zip(tables, freqs)):
        norms = np.linalg.norm(table, axis=1)
        fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(8, 8))
        fig.suptitle(
            f"Categorical variable {t}: cardinality {len(f)}"
        )
        ax0.plot(f)
        ax0.set_yscale("log")
        ax0.set_title("Counts", fontsize=10)
        ax1.plot(norms)
        ax1.set_title("Norms", fontsize=10)
        png = os.path.join(output_dir, f"cat_counts-{t:03d}.png")
        fig.savefig(png)
        plt.close(fig)
        out[f"cat_counts_{t}"] = png
    return out


def index_frequencies(indices: np.ndarray, rows: int) -> np.ndarray:
    """Access counts per categorical value from a [B, L] / flat index
    stream (the reference's categorical-frequency analysis,
    visualize.py:232-316)."""
    return np.bincount(indices.reshape(-1), minlength=rows)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def visualize_tables(
    tables: List[np.ndarray],
    output_dir: str,
    max_rows: int = 2000,
    methods: tuple = ("pca",),
    do_cluster: bool = False,
    freqs: Optional[List[np.ndarray]] = None,
    seed: int = 0,
) -> Dict[str, str]:
    """Project each table to 2-D, color by frequency (if provided) or
    cluster id, save PNG + npz per table. Returns {artifact: path}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    out = {}
    for t, w in enumerate(tables):
        n = w.shape[0]
        sel = rng.choice(n, size=min(n, max_rows), replace=False)
        x = np.asarray(w)[sel].astype(np.float64)
        f = freqs[t][sel] if freqs is not None else None
        labels = cluster_labels(x) if do_cluster else None
        for method in methods:
            if method == "pca":
                proj = pca_2d(x)
            elif method == "tsne":
                proj = tsne_2d(x, seed)
            elif method == "umap":
                proj = umap_2d(x, seed)
                if proj is None:
                    continue
            else:
                raise ValueError(f"unknown method {method!r}")
            fig, ax = plt.subplots(figsize=(6, 5))
            c = (
                np.log1p(f)
                if f is not None
                else (labels if labels is not None else None)
            )
            s = ax.scatter(proj[:, 0], proj[:, 1], s=4, c=c, cmap="viridis")
            if c is not None:
                fig.colorbar(
                    s, ax=ax,
                    label="log(1+freq)" if f is not None else "cluster",
                )
            ax.set_title(f"table {t}: {method} of {x.shape[0]}/{n} rows")
            png = os.path.join(output_dir, f"table{t}_{method}.png")
            fig.savefig(png, dpi=120)
            plt.close(fig)
            out[f"table{t}_{method}"] = png
            npz = os.path.join(output_dir, f"table{t}_{method}.npz")
            np.savez(npz, projection=proj, row_ids=sel,
                     **({"freq": f} if f is not None else {}),
                     **({"cluster": labels} if labels is not None else {}))
        if f is not None:
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.hist(np.log1p(freqs[t][freqs[t] > 0]), bins=50)
            ax.set_xlabel("log(1+freq)")
            ax.set_title(f"table {t}: categorical access frequency")
            png = os.path.join(output_dir, f"table{t}_freq.png")
            fig.savefig(png, dpi=120)
            plt.close(fig)
            out[f"table{t}_freq"] = png
    return out


def load_tables_from_checkpoint(ckpt_dir: str, config) -> List[np.ndarray]:
    """Every canonical table's rows [n, dim] (f32) from a checkpoint of the
    model ``config`` describes, read on the CPU."""
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm, model_groups
    from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, init_opt_state
    from dlrm_yx_tpu_torch.train.checkpoint import load_checkpoint

    params_like = init_dlrm(config, seed=0, device="cpu")
    groups = model_groups(config)
    opt_like = init_opt_state(OptConfig("sgd", 0.1), params_like, groups)
    params, _, _ = load_checkpoint(ckpt_dir, params_like, opt_like)
    tables = {}
    for g, store in zip(groups, params["emb"]):
        s = store.float().numpy()
        for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            tables[tid] = s[off : off + n]
    return [tables[t] for t in sorted(tables)]


def main(argv=None):
    p = argparse.ArgumentParser(description="DLRM embedding visualization")
    p.add_argument("--load-model", type=str, required=True,
                   help="checkpoint directory")
    p.add_argument("--arch-embedding-size", type=str, required=True)
    p.add_argument("--arch-sparse-feature-size", type=int, required=True)
    p.add_argument("--arch-mlp-bot", type=str, required=True)
    p.add_argument("--arch-mlp-top", type=str, required=True)
    p.add_argument("--output-dir", type=str, default="./viz")
    p.add_argument("--max-rows", type=int, default=2000)
    p.add_argument("--tsne", action="store_true")
    p.add_argument("--umap", action="store_true")
    p.add_argument("--cluster", action="store_true")
    p.add_argument("--freq-npz", type=str, default=None,
                   help="npz with per-table index arrays idx_0..idx_{T-1} "
                        "for frequency coloring")
    p.add_argument("--freq-source", type=str, default=None,
                   choices=["random", "synthetic", "bin"],
                   help="drive categorical frequencies from ACTUAL loader "
                        "batches instead of a side npz: random/synthetic "
                        "generators or the --raw-data-file bin loader")
    p.add_argument("--raw-data-file", type=str, default="")
    p.add_argument("--data-trace-file", type=str,
                   default="./input/dist_emb_j.log")
    p.add_argument("--freq-batches", type=int, default=32)
    p.add_argument("--mini-batch-size", type=int, default=128)
    p.add_argument("--num-indices-per-lookup", type=int, default=2)
    p.add_argument("--per-feature", action="store_true",
                   help="per-variable counts+norms figures (the "
                        "reference's analyse_categorical_counts)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from dlrm_yx_tpu_torch.config import DLRMConfig

    ln_bot = tuple(int(x) for x in args.arch_mlp_bot.split("-"))
    if ln_bot[-1] != args.arch_sparse_feature_size:
        raise SystemExit(
            f"--arch-sparse-feature-size {args.arch_sparse_feature_size} != "
            f"bottom MLP output dim {ln_bot[-1]}"
        )
    rows = tuple(int(x) for x in args.arch_embedding_size.split("-"))
    top = tuple(int(x) for x in args.arch_mlp_top.split("-"))
    # the CLI convention (reference parity): --arch-mlp-top lists
    # hidden+output dims, the interaction input dim is computed
    d = ln_bot[-1]
    f = len(rows) + 1
    top_in = f * (f - 1) // 2 + d
    config = DLRMConfig(
        emb_rows=rows,
        ln_bot=ln_bot,
        ln_top=(top_in,) + top if top[0] != top_in else top,
    )
    tables = load_tables_from_checkpoint(args.load_model, config)
    freqs = None
    if args.freq_source:
        if args.freq_source == "random":
            from dlrm_yx_tpu_torch.data.synthetic import (
                RandomDataConfig,
                make_random_batches,
            )

            batches = make_random_batches(RandomDataConfig(
                emb_rows=config.emb_rows, m_den=config.ln_bot[0],
                mini_batch_size=args.mini_batch_size,
                num_batches=args.freq_batches,
                num_indices_per_lookup=args.num_indices_per_lookup,
                num_indices_per_lookup_fixed=False, round_targets=True,
                seed=args.seed,
            ))
        elif args.freq_source == "synthetic":
            from dlrm_yx_tpu_torch.data.trace import make_trace_batches

            batches = make_trace_batches(
                args.data_trace_file, config.emb_rows, config.ln_bot[0],
                args.mini_batch_size, args.freq_batches,
                args.num_indices_per_lookup, False, seed=args.seed,
            )
        else:  # bin
            from dlrm_yx_tpu_torch.data.criteo_bin import CriteoBinLoader

            batches = CriteoBinLoader(
                args.raw_data_file, batch_size=args.mini_batch_size
            )
        freqs = collect_frequencies_from_loader(
            batches, config.emb_rows, args.freq_batches
        )
    elif args.freq_npz:
        with np.load(args.freq_npz) as d:
            freqs = [
                index_frequencies(d[f"idx_{t}"], n)
                for t, n in enumerate(config.emb_rows)
            ]
    methods = ["pca"] + (["tsne"] if args.tsne else []) + (
        ["umap"] if args.umap else []
    )
    out = visualize_tables(
        tables, args.output_dir, args.max_rows, tuple(methods),
        args.cluster, freqs, args.seed,
    )
    if args.per_feature:
        if freqs is None:
            raise SystemExit("--per-feature needs --freq-source/--freq-npz")
        out.update(per_feature_analysis(tables, freqs, args.output_dir))
    print(json.dumps({k: v for k, v in sorted(out.items())}, indent=1))


if __name__ == "__main__":
    main()
