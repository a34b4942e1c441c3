"""Synthesize a Kaggle-DAC-format ``train.txt`` with LEARNABLE click signal.

A copy of ``dlrm_yx_tpu/data/synth_kaggle.py``: for the same seed and row
count it writes the same bytes.

The reference ships against the real Criteo Kaggle dataset
(``bench/dlrm_s_criteo_kaggle.sh:24``; format: one TSV row
per impression, ``label \\t 13 int features \\t 26 hex categorical ids``,
with missing fields empty). That dataset cannot be redistributed, so this
tool generates a statistically Criteo-LIKE file for end-to-end dress
rehearsals of the full dataset path: split -> preprocess -> dictionaries ->
reorder -> train -> periodic eval -> accuracy early-stop -> checkpoint
resume — exercising exactly the pipeline the real data takes
(SURVEY.md §3.6), at any size.

Criteo-like properties reproduced:
  * 26 categorical features with wildly mixed vocabulary sizes (a few
    100k-scale, many tiny — the Kaggle counts span 3 .. 10M+);
  * Zipf-ish category popularity (power-law sampling);
  * raw ids are scattered 32-bit values (hashed-looking hex), NOT dense —
    the preprocessing dictionaries must do real work;
  * ~3% missing categorical fields, ~10% missing/negative dense fields;
  * positives are a minority class (configurable CTR, default ~25% like
    the sub-sampled DAC data).

LEARNABLE signal: a hidden sparse model assigns each (feature, category)
a latent weight and each dense feature a small coefficient; labels are
Bernoulli(sigmoid(score)). A DLRM trained on the output should beat the
base rate by a wide margin (the dress-rehearsal test asserts it), so
--mlperf-acc-threshold early-stop is exercised for real.

CLI:
  python -m dlrm_yx_tpu_torch.data.synth_kaggle --rows 2000000 --out /tmp/train.txt
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# vocab sizes: 26 features spanning tiny..large like the Kaggle DAC counts
# (scaled down; real counts span 3..10M). Kept deterministic and importable
# so tests can size expectations.
VOCAB_SIZES = (
    120_000, 30_000, 8_000, 4_000, 300, 20, 11_000, 600, 3, 45_000,
    5_000, 90_000, 3_000, 26, 9_000, 60_000, 10, 4_200, 1_800, 4,
    70_000, 15, 14, 25_000, 80, 40_000,
)

_MIX = np.uint64(2654435761)  # Knuth multiplicative hash -> scattered ids


def _hex_vocab(rng: np.random.RandomState, n: int, feat: int) -> np.ndarray:
    """Hashed-looking 8-hex-digit raw ids for one feature's vocabulary."""
    ids = (np.arange(n, dtype=np.uint64) + np.uint64(feat) * np.uint64(1 << 20))
    mixed = (ids * _MIX) % np.uint64(1 << 32)
    return np.array([format(int(x), "08x") for x in mixed])


def _powerlaw(rng: np.random.RandomState, n: int, size: int, a: float = 1.15):
    """Zipf-ish category ranks in [0, n) (rank 0 most popular)."""
    u = rng.random_sample(size)
    # inverse-CDF of a truncated power law on [1, n]
    r = (1.0 - u * (1.0 - n ** (1.0 - a))) ** (1.0 / (1.0 - a))
    return np.minimum(r.astype(np.int64), n - 1)


def generate(
    out_path: str,
    rows: int,
    seed: int = 0,
    ctr: float = 0.25,
    chunk: int = 200_000,
    progress: bool = False,
    signal_scale: float = 1.0,
) -> dict:
    """Write ``rows`` TSV lines to ``out_path``. Returns summary stats.

    signal_scale multiplies the hidden latent weights: 1.0 gives a
    Criteo-like hard problem (Bayes AUC ~0.78); ~1.8 gives a strongly
    learnable stream (Bayes AUC ~0.85) for AUC-threshold early-stop
    rehearsals (--mlperf-auc-threshold semantics)."""
    rng = np.random.RandomState(seed)
    nf = len(VOCAB_SIZES)
    vocab_hex = [_hex_vocab(rng, n, j) for j, n in enumerate(VOCAB_SIZES)]
    # hidden model: per-category latent weights, stronger on small vocabs
    # (frequent categories get more training signal either way)
    lat = [
        rng.randn(n).astype(np.float32)
        * (signal_scale * (1.2 if n <= 1000 else 0.8))
        for n in VOCAB_SIZES
    ]
    wd = (rng.randn(13) * 0.25).astype(np.float32)
    # bias calibrated so mean sigmoid ~ ctr given score std ~ sqrt(sum var)
    bias = float(np.log(ctr / (1.0 - ctr)) - 0.0)

    n_pos = 0
    t0 = time.perf_counter()
    with open(out_path, "w") as f:
        for lo in range(0, rows, chunk):
            m = min(chunk, rows - lo)
            cats = np.empty((m, nf), dtype=np.int64)
            score = np.full(m, bias, np.float32)
            for j in range(nf):
                cj = _powerlaw(rng, VOCAB_SIZES[j], m)
                cats[:, j] = cj
                score += lat[j][cj] * np.float32(1.0 / np.sqrt(nf))
            # dense counts: lognormal-ish, correlated with the label score
            dense = rng.poisson(3.0, (m, 13)).astype(np.int64)
            dense[:, 0] += np.maximum(0, (score * 2).astype(np.int64))
            score += (np.log1p(np.maximum(dense, 0)) @ wd).astype(
                np.float32
            ) * 0.2
            y = (rng.random_sample(m) < 1.0 / (1.0 + np.exp(-score))).astype(
                np.int32
            )
            n_pos += int(y.sum())

            ystr = y.astype("U1")
            dstr = dense.astype("U12")
            dstr[rng.random_sample((m, 13)) < 0.10] = ""
            cstr = np.empty((m, nf), dtype="U8")
            for j in range(nf):
                cstr[:, j] = vocab_hex[j][cats[:, j]]
            cstr[rng.random_sample((m, nf)) < 0.03] = ""
            cols = np.concatenate([ystr[:, None], dstr, cstr], axis=1)
            f.write("\n".join("\t".join(r) for r in cols) + "\n")
            if progress:
                done = lo + m
                dt = time.perf_counter() - t0
                print(
                    f"  synth {done}/{rows} rows ({done/dt:,.0f} rows/s)",
                    flush=True,
                )
    return {
        "rows": rows,
        "ctr": n_pos / max(rows, 1),
        "gen_seconds": time.perf_counter() - t0,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=2_000_000)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ctr", type=float, default=0.25)
    args = p.parse_args(argv)
    stats = generate(args.out, args.rows, args.seed, args.ctr, progress=True)
    print(stats)


if __name__ == "__main__":
    main()
