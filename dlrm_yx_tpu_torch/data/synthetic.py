"""Random synthetic data generation (host side, numpy).

A copy of the host generator in ``dlrm_yx_tpu/data/synthetic.py``, with the
same draw sequence, so both packages see identical batches from one seed.
It mirrors the reference's random pipeline
(``dlrm_data_pytorch.py:1031-1230``):
  * uniform indices: unique-ified groups of round(r * (n-1)); with
    num_indices_per_lookup_fixed the group is re-drawn until exactly L unique
    indices;
  * variable pooling: group size = round(max(1, r * min(n, L)))
    before unique-ification;
  * gaussian indices with clipping;
  * targets uniform in [0,1), optionally rounded (round_targets).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from dlrm_yx_tpu_torch.data.batch import Batch


@dataclasses.dataclass(frozen=True)
class RandomDataConfig:
    emb_rows: Tuple[int, ...]
    m_den: int
    mini_batch_size: int
    num_batches: int
    num_indices_per_lookup: int = 1
    num_indices_per_lookup_fixed: bool = True
    dist: str = "uniform"  # uniform | gaussian
    rand_data_min: float = 0.0
    rand_data_max: float = 1.0
    rand_data_mu: float = -1.0
    rand_data_sigma: float = 1.0
    round_targets: bool = False
    seed: int = 123


def _uniform_group(rng, n: int, l: int, fixed: bool) -> np.ndarray:
    if fixed:
        size = min(n, l)
        while True:
            r = rng.random_sample(size)
            group = np.unique(np.round(r * (n - 1)).astype(np.int64))
            if group.size == size:
                return group
    r = rng.random_sample(1)
    size = np.int64(np.round(max([1.0], r * min(n, l))))
    r = rng.random_sample(size)
    return np.unique(np.round(r * (n - 1)).astype(np.int64))


def _gaussian_group(rng, n: int, l: int, fixed: bool, cfg: "RandomDataConfig") -> np.ndarray:
    if fixed:
        size = np.int64(l)
    else:
        r = rng.random_sample(1)
        size = np.int64(np.round(max([1.0], r * min(n, l))))
    mu = cfg.rand_data_mu
    if mu == -1:
        mu = (cfg.rand_data_max + cfg.rand_data_min) / 2.0
    r = rng.normal(mu, cfg.rand_data_sigma, size)
    group = np.clip(r, cfg.rand_data_min, cfg.rand_data_max)
    return np.unique(group).astype(np.int64)


def make_random_batches(cfg: RandomDataConfig, seed: Optional[int] = None) -> List[Batch]:
    """Pre-generate num_batches batches (the reference also pre-generates
    all batches up front). The loop over T x B draws is Python, about 0.5 s
    per batch at B=2048 and 26 tables."""
    rng = np.random.RandomState(cfg.seed if seed is None else seed)
    t = len(cfg.emb_rows)
    b = cfg.mini_batch_size
    l = cfg.num_indices_per_lookup
    batches = []
    for _ in range(cfg.num_batches):
        dense = rng.random_sample((b, cfg.m_den)).astype(np.float32)
        indices = np.zeros((t, b, l), dtype=np.int32)
        weights = np.zeros((t, b, l), dtype=np.float32)
        for k, n in enumerate(cfg.emb_rows):
            for i in range(b):
                if cfg.dist == "uniform":
                    group = _uniform_group(rng, n, l, cfg.num_indices_per_lookup_fixed)
                elif cfg.dist == "gaussian":
                    group = _gaussian_group(rng, n, l, cfg.num_indices_per_lookup_fixed, cfg)
                else:
                    raise ValueError(f"unknown dist {cfg.dist!r}")
                m = min(len(group), l)
                indices[k, i, :m] = group[:m]
                weights[k, i, :m] = 1.0
        labels = rng.random_sample((b, 1)).astype(np.float32)
        if cfg.round_targets:
            labels = np.round(labels).astype(np.float32)
        batches.append(Batch(dense, indices, weights, labels))
    return batches
