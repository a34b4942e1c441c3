"""Random synthetic data generation.

A copy of the host generator in ``dlrm_yx_tpu/data/synthetic.py``, with the
same draw sequence, so both packages see identical batches from one seed,
and ``make_device_random_batches``, which draws batches on the device.
It mirrors the reference's random pipeline
(``dlrm_data_pytorch.py:1031-1230``):
  * uniform indices: unique-ified groups of round(r * (n-1)); with
    num_indices_per_lookup_fixed the group is re-drawn until exactly L unique
    indices;
  * variable pooling: group size = round(max(1, r * min(n, L)))
    before unique-ification;
  * gaussian indices with clipping;
  * targets uniform in [0,1), optionally rounded (round_targets).

With ``multi_hot_sizes`` (the port's own; DLRM-DCNv2's fixed bags) a batch
is in the bag layout instead: ids [sum(h), B, 1], each of table t's
``h_t`` slots uniform over its rows (repeats allowed, as the reference's
synthetic multi-hot data has them), weights ones [sum(h), 1, 1] (a bag
is unweighted and they are not read), the dense features and targets as
above.

``make_sequence_batches`` draws HSTU's jagged batches (``SeqBatch``):
user histories of log-uniform lengths packed to the token budget, uniform
items and negatives, timestamps rising by log-normal gaps;
``seq_batch`` lays out such a batch from its histories, and
``history_times`` their timestamps from the gaps between events.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from dlrm_yx_tpu_torch.data.batch import Batch, SeqBatch


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
    # fixed bag sizes per table: bags of uniform ids in the slot layout
    multi_hot_sizes: Tuple[int, ...] = ()


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
    if cfg.multi_hot_sizes:
        return _bag_batches(cfg, rng)
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


def _bag_batches(cfg: RandomDataConfig, rng) -> List[Batch]:
    b = cfg.mini_batch_size
    rows = np.repeat(np.asarray(cfg.emb_rows, np.int64), cfg.multi_hot_sizes)
    batches = []
    for _ in range(cfg.num_batches):
        dense = rng.random_sample((b, cfg.m_den)).astype(np.float32)
        idx = (rng.random_sample((len(rows), b)) * rows[:, None]).astype(np.int64)
        indices = np.minimum(idx, rows[:, None] - 1).astype(np.int32)[:, :, None]
        labels = rng.random_sample((b, 1)).astype(np.float32)
        if cfg.round_targets:
            labels = np.round(labels).astype(np.float32)
        batches.append(Batch(dense, indices, np.ones((len(rows), 1, 1), np.float32), labels))
    return batches


def make_device_random_batches(emb_rows, m_den: int, mini_batch_size: int,
                               num_batches: int, num_indices_per_lookup: int,
                               num_indices_per_lookup_fixed: bool = False,
                               round_targets: bool = True, seed: int = 123,
                               device="cuda"):
    """Random batches drawn on the device (``--data-generation
    random-device``): the port of ``make_device_random_batches`` in
    ``dlrm_yx_tpu/data/synthetic.py``. A synthetic benchmark is then not
    bound by the host's generator or its copy to the card. Returns a
    sequence of ``num_batches`` batches of tensors on ``device``, each
    drawn when it is asked for.

    Batch ``i`` is drawn by a ``torch.Generator`` on ``device`` seeded from
    (seed, i), as the JAX package folds i into its key, so indexing or
    iterating again gives the same batch. The formulas are the JAX
    package's: dense uniform in [0, 1); indices floor(u * rows) for each
    table; with a variable lookup length, lengths uniform in 1..L and a
    weight prefix of ones; labels uniform, or (u > 0.5) when
    ``round_targets``. The draws are torch's, not ``jax.random``'s: the
    two packages get other batches from one seed (not a fault; ROADMAP
    Queue C)."""
    return _DeviceBatches(emb_rows, m_den, mini_batch_size, num_batches,
                          num_indices_per_lookup, num_indices_per_lookup_fixed,
                          round_targets, seed, torch.device(device))


class _DeviceBatches:
    def __init__(self, emb_rows, m_den, mini_batch_size, num_batches,
                 num_indices_per_lookup, num_indices_per_lookup_fixed, round_targets,
                 seed, device):
        self.shape = (len(emb_rows), mini_batch_size, num_indices_per_lookup)
        self.m_den = m_den
        self.num_batches = num_batches
        self.fixed = num_indices_per_lookup_fixed
        self.round_targets = round_targets
        self.seed = seed
        self.device = device
        self.rows = torch.tensor(emb_rows, dtype=torch.int64, device=device)

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        return (self[i] for i in range(self.num_batches))

    def __getitem__(self, i: int) -> Batch:
        if not 0 <= i < self.num_batches:
            raise IndexError(i)
        t, b, l = self.shape
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.SeedSequence([self.seed, i]).generate_state(
            1, np.uint64)[0] >> np.uint64(1)))
        dev = self.device
        dense = torch.rand((b, self.m_den), generator=gen, device=dev)
        u = torch.rand((t, b, l), generator=gen, device=dev)
        rows = self.rows[:, None, None]
        # an f32 product can round up to rows itself past 2**24 rows
        idx = torch.minimum((u * rows).long(), rows - 1).to(torch.int32)
        if self.fixed:
            w = torch.ones((t, b, l), device=dev)
        else:
            lens = torch.randint(1, l + 1, (t, b), generator=gen, device=dev)
            w = (torch.arange(l, device=dev) < lens[..., None]).float()
        y = torch.rand((b, 1), generator=gen, device=dev)
        if self.round_targets:
            y = (y > 0.5).float()
        return Batch(dense, idx, w, y)


def seq_batch(ids: np.ndarray, times: np.ndarray, lengths: np.ndarray, negatives: np.ndarray,
              max_sequences: int) -> SeqBatch:
    """The ``SeqBatch`` of histories of ``lengths`` (summing to T) laid
    back to back with their items ``ids`` [T], timestamps ``times`` [T]
    and negatives [T, R]: offsets padded to ``max_sequences`` + 1 with T,
    each position's positive the next event's item and its weight 1 where
    the next event is in its history. Timestamps may not fall within a
    history."""
    lengths = np.asarray(lengths, np.int64)
    t = int(lengths.sum())
    if ids.shape[0] != t or lengths.shape[0] > max_sequences:
        raise ValueError(f"{lengths.shape[0]} histories of {t} events for {ids.shape[0]} "
                         f"tokens and a bound of {max_sequences} histories")
    offsets = np.full(max_sequences + 1, t, np.int32)
    offsets[1:lengths.shape[0] + 1] = np.cumsum(lengths)
    offsets[0] = 0
    last = np.zeros(t, bool)
    last[np.cumsum(lengths)[lengths > 0] - 1] = True
    if (np.diff(times)[~last[:-1]] < 0).any():
        raise ValueError("timestamps must not fall within a history (the attention's time "
                         "buckets are read off rows that never rise)")
    positives = np.where(last, 0, np.roll(ids, -1)).astype(np.int32)
    return SeqBatch(ids.astype(np.int32), times.astype(np.int64), offsets, positives,
                    negatives.astype(np.int32), (~last).astype(np.float32))


def history_times(gaps: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Each event's timestamp [T] int64 of histories of ``lengths`` laid
    back to back: each history's times rise from 0 by its events' ``gaps``
    [T] (a history's first gap is not read)."""
    lengths = np.asarray(lengths, np.int64)
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    csum = np.cumsum(np.asarray(gaps, np.int64))
    return csum - csum[starts]


def history_lengths(rng, tokens: int, lo: int, hi: int) -> np.ndarray:
    """Lengths log-uniform on [lo, hi], drawn until they fill ``tokens``,
    the last one cut to fit."""
    out, total = [], 0
    while total < tokens:
        n = min(int(np.exp(rng.uniform(np.log(lo), np.log(hi + 1)))), hi, tokens - total)
        out.append(n)
        total += n
    return np.asarray(out, np.int64)


def make_sequence_batches(config, num_batches: int, seed: int = 123) -> List[SeqBatch]:
    """``num_batches`` HSTU batches of ``config`` (an ``HSTUConfig``) from
    one numpy RandomState: history lengths log-uniform on [1, max_seq_len],
    items and negatives uniform over the table, timestamps rising from 0 by
    log-normal gaps (median 60 s, sigma 2)."""
    rng = np.random.RandomState(seed)
    c = config
    out = []
    for _ in range(num_batches):
        lengths = history_lengths(rng, c.tokens_per_batch, 1, c.max_seq_len)
        t = c.tokens_per_batch
        ids = rng.randint(0, c.num_items, t)
        gaps = np.exp(rng.normal(np.log(60.0), 2.0, t)).astype(np.int64)
        times = history_times(gaps, lengths)
        negatives = rng.randint(0, c.num_items, (t, c.num_negatives))
        out.append(seq_batch(ids, times, lengths, negatives, c.max_sequences))
    return out


def save_batches_hdf5(path: str, batches) -> None:
    """Write batches to an HDF5 file, one group a batch (the reference's
    per-batch .hdf5 persistence of RandomDataset); numpy or tensors."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["num_batches"] = len(batches)
        for i, b in enumerate(batches):
            g = f.create_group(f"batch_{i}")
            for name in Batch._fields:
                g.create_dataset(name, data=np.asarray(torch.as_tensor(getattr(b, name)).cpu()))


def load_batches_hdf5(path: str) -> List[Batch]:
    """The batches ``save_batches_hdf5`` wrote, as numpy."""
    import h5py

    with h5py.File(path, "r") as f:
        return [Batch(*(np.asarray(f[f"batch_{i}"][name]) for name in Batch._fields))
                for i in range(int(f.attrs["num_batches"]))]
