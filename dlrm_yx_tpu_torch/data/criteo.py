"""Criteo Kaggle / Terabyte preprocessing and loading.

A copy of ``dlrm_yx_tpu/data/criteo.py``: the same artifacts, byte for
byte, and the same batches. Capability parity with the reference's
pipeline (``data_utils.py`` + ``dlrm_data_pytorch.py:54-345``), with
byte-compatible artifact formats, so preprocessed data is interchangeable:

  raw TSV (train.txt / day_0..day_23)
    → ``{prefix}_day_{i}.npz``            keys X_int [n,13] i4,
                                          X_cat_t [26,n] i4 (raw hashed ids),
                                          y [n] i4
    → ``{prefix}_day_count.npz``          key total_per_file
    → ``{prefix}_fea_dict_{j}.npz``       key unique (raw ids, first-appearance
                                          order = dense id order)
    → ``{prefix}_fea_count.npz``          key counts [26]
    → ``{prefix}_day_{i}_processed.npz``  keys X_int, X_cat [n,26] (dense ids), y
    → ``{prefix}_day_{i}_reordered.npz``  same keys, per-day shuffled
    → or one concatenated ``<out>.npz``   keys X_int, X_cat, y, counts

Vectorized numpy (chunked TSV parse + np.searchsorted remap); the native
host code of ``fastparse`` (``csrc/fastparse.cpp``) parses the raw TSV and
builds the dictionaries when ``g++`` is present, and numpy does both
otherwise.

Split semantics (dlrm_data_pytorch.py:54-345): train = days 0..n-2
(shuffled per-day or total), test/val = first/second half of the last day;
dense transform log(x+1); X_cat % max_ind_range at load time.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dlrm_yx_tpu_torch.data.batch import Batch

DEN = 13
SPA = 26


# ---------------------------------------------------------------------------
# stage 1: raw TSV -> per-day npz
# ---------------------------------------------------------------------------

def parse_raw_tsv(
    path: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    rng: Optional[np.random.RandomState] = None,
    chunk_lines: int = 1 << 18,
    seed: int = 123,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse one raw Criteo TSV file (label \\t 13 ints \\t 26 hex ids).

    Missing fields become 0; dense negatives are preserved here (zeroed at
    the *processed* stage, matching the reference); hex ids are parsed to
    int32 with optional % max_ind_range; zero-target rows are sub-sampled
    with probability sub_sample_rate.

    ``seed`` drives the sub-sampling stream on BOTH the native and the
    numpy path (the run seed, --numpy-rand-seed in the reference,
    dlrm_s_pytorch.py:1338). The two paths use different RNGs so the kept
    ROW SETS differ between them, but each path is deterministic for a
    given seed and both keep zero-target rows at the same expected rate.
    Returns (y [n] i4, X_int [n,13] i4, X_cat [n,26] i4).
    """
    try:
        from dlrm_yx_tpu_torch.data import fastparse

        if fastparse.available():
            return fastparse.parse_raw_tsv(
                path, max_ind_range, sub_sample_rate, seed
            )
    except Exception:
        pass
    rng = rng or np.random.RandomState(seed)
    ys, xis, xcs = [], [], []
    with open(path) as f:
        while True:
            lines = f.readlines(chunk_lines)
            if not lines:
                break
            n = len(lines)
            y = np.zeros(n, dtype=np.int32)
            xi = np.zeros((n, DEN), dtype=np.int32)
            xc = np.zeros((n, SPA), dtype=np.int32)
            for i, line in enumerate(lines):
                parts = line.rstrip("\n").split("\t")
                y[i] = int(parts[0]) if parts[0] else 0
                for j in range(DEN):
                    v = parts[1 + j]
                    xi[i, j] = int(v) if v else 0
                for j in range(SPA):
                    v = parts[1 + DEN + j] if 1 + DEN + j < len(parts) else ""
                    raw = int(v, 16) if v else 0
                    if max_ind_range > 0:
                        raw %= max_ind_range
                    xc[i, j] = raw
            if sub_sample_rate > 0.0:
                keep = (y != 0) | (rng.uniform(size=n) >= sub_sample_rate)
                y, xi, xc = y[keep], xi[keep], xc[keep]
            ys.append(y)
            xis.append(xi)
            xcs.append(xc)
    return (
        np.concatenate(ys) if ys else np.zeros(0, np.int32),
        np.concatenate(xis) if xis else np.zeros((0, DEN), np.int32),
        np.concatenate(xcs) if xcs else np.zeros((0, SPA), np.int32),
    )


def split_kaggle_train_txt(raw_path: str, days: int = 7) -> List[str]:
    """Split the single Kaggle train.txt into per-day text files of
    near-even line counts (the reference's day split,
    data_utils.py:906-964). Returns the day file paths.

    Streams in two passes at constant memory (Kaggle train.txt is ~11 GB,
    Terabyte day files are far larger — a readlines() would need the whole
    file in RSS; the reference also streams line-by-line with per-day
    fan-out, data_utils.py:906-1130)."""
    total = 0
    with open(raw_path, "rb") as f:
        for _ in f:
            total += 1
    per = [total // days + (1 if i < total % days else 0) for i in range(days)]
    base = raw_path.rsplit(".", 1)[0]
    out = [f"{base}_day_{i}.txt" for i in range(days)]
    with open(raw_path, "rb") as src:
        for i, n in enumerate(per):
            with open(out[i], "wb") as dst:
                for _ in range(n):
                    dst.write(src.readline())
    return out


def _parse_one_day(args):
    """Stage-1 worker (module-level so multiprocessing can pickle it).
    Sub-sampling is seeded per-day (seed + day index) so the kept row set
    is identical whether days run in-process or across a Pool."""
    df, day_npz, max_ind_range, sub_sample_rate, seed, compress = args
    y, xi, xc = parse_raw_tsv(df, max_ind_range, sub_sample_rate, seed=seed)
    save = np.savez_compressed if compress else np.savez
    save(day_npz, X_int=xi, X_cat_t=np.ascontiguousarray(xc.T), y=y)
    return len(y)


def preprocess_criteo(
    day_files: Sequence[str],
    prefix: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    randomize: str = "total",
    data_split: str = "train",
    seed: int = 123,
    concat_output: Optional[str] = None,
    compress: bool = False,
    nprocs: int = 1,
) -> dict:
    """Run the full offline pipeline on per-day raw files, writing every
    artifact listed in the module docstring under ``prefix``.

    randomize: 'none' | 'day' (shuffle within each train day) | 'total'
      (shuffle across all train days); the last day is never shuffled
      (it becomes test/val), matching concatCriteoAdData semantics.
    concat_output: if set, additionally writes one concatenated npz (the
      Kaggle non-memmap flow) at ``{concat_output}.npz``.
    compress: zlib-compress the npz artifacts (np.load reads both forms
      transparently, so every reader — including the reference's — keeps
      working; deflating the same tensors up to four times was the
      dominant cost of the whole pipeline). Default off; pass True for
      the reference's smaller on-disk footprint.
    nprocs: day-parallel fan-out for the parse stage (the reference's
      --dataset-multiprocessing, data_utils.py:1096-1130);
      1 = in-process.
    Returns {'counts': [26], 'total_per_file': [days], 'stage_seconds'} —
    the last is the per-stage wall budget (parse/dict/remap/shuffle).
    """
    import time as _time

    rng = np.random.RandomState(seed)
    days = len(day_files)
    total_per_file: List[int] = [0] * days
    save = np.savez_compressed if compress else np.savez
    stage_s = {}

    # stage 1: parse raw -> day npz (skip existing)
    t0 = _time.perf_counter()
    todo = []
    for i, df in enumerate(day_files):
        day_npz = f"{prefix}_day_{i}.npz"
        if os.path.exists(day_npz):
            with np.load(day_npz) as d:
                total_per_file[i] = len(d["y"])
        else:
            todo.append((i, (df, day_npz, max_ind_range, sub_sample_rate,
                             seed + i, compress)))
    if todo and nprocs > 1:
        # spawn, not fork: the caller has usually initialized torch (and
        # CUDA) already, and forking a process with live runtime threads
        # can deadlock; the workers only need numpy + the ctypes parser
        from multiprocessing import get_context

        with get_context("spawn").Pool(min(nprocs, len(todo))) as pool:
            for (i, _), n in zip(
                todo, pool.map(_parse_one_day, [a for _, a in todo])
            ):
                total_per_file[i] = n
    else:
        for i, args in todo:
            total_per_file[i] = _parse_one_day(args)
    save(
        f"{prefix}_day_count.npz", total_per_file=np.array(total_per_file)
    )
    stage_s["parse"] = _time.perf_counter() - t0

    # stage 2: dictionaries — first-appearance order across days (the
    # reference's dict-insertion order, data_utils.py:1141-1156). With the
    # native library: one streaming pass through insertion-order flat hash
    # maps (csrc/fastparse.cpp FlatMap, ~15 ns/row — replaces per-day
    # sort-based np.unique + membership, the reference's Cython stage).
    # Numpy fallback carries a SORTED copy of each dictionary so per-day
    # membership is one searchsorted instead of np.isin re-sorting the
    # whole dictionary every day.
    t0 = _time.perf_counter()
    db = None
    try:
        from dlrm_yx_tpu_torch.data import fastparse as _fp

        if _fp.available():
            db = _fp.DictBuilder(SPA)
    except Exception:
        db = None
    uniques: List[np.ndarray] = [np.zeros(0, np.int32) for _ in range(SPA)]
    uniq_sorted: List[np.ndarray] = [np.zeros(0, np.int32) for _ in range(SPA)]
    for i in range(days):
        with np.load(f"{prefix}_day_{i}.npz") as d:
            xct = d["X_cat_t"]
        for j in range(SPA):
            col = xct[j]
            if db is not None:
                db.update(j, col)
                continue
            # new values in first-appearance order within this day
            _, first_idx = np.unique(col, return_index=True)
            day_new = col[np.sort(first_idx)]
            us = uniq_sorted[j]
            if len(us):
                pos = np.minimum(
                    np.searchsorted(us, day_new), len(us) - 1
                )
                fresh = day_new[us[pos] != day_new]
            else:
                fresh = day_new
            if len(fresh):
                uniques[j] = np.concatenate([uniques[j], fresh])
                uniq_sorted[j] = np.sort(np.concatenate([us, fresh]))
    if db is not None:
        uniques = [db.uniques(j) for j in range(SPA)]
    counts = np.array([len(u) for u in uniques], dtype=np.int32)
    for j in range(SPA):
        save(
            f"{prefix}_fea_dict_{j}.npz", unique=uniques[j].astype(np.int32)
        )
    save(f"{prefix}_fea_count.npz", counts=counts)
    stage_s["dict"] = _time.perf_counter() - t0

    # remap helper for the numpy fallback: raw id -> dense id (position in
    # the first-appearance list)
    remaps = []
    if db is None:
        for j in range(SPA):
            order = np.argsort(uniques[j], kind="stable")
            remaps.append((uniques[j][order], order.astype(np.int32)))

    # stages 3+4, fused per day (one read instead of two): processed npz
    # (dense ids, clamped dense features) then reorder/shuffle npz. Both
    # artifacts are still written; the rng.permutation stream is drawn in
    # day order exactly as the unfused loops did.
    stage_s["remap"] = 0.0
    stage_s["shuffle"] = 0.0
    for i in range(days):
        p_out = f"{prefix}_day_{i}_processed.npz"
        r_out = f"{prefix}_day_{i}_reordered.npz"
        is_train_day = (data_split != "train") or (i < days - 1)
        want_shuffle = (
            randomize in ("day", "total") and is_train_day and i < days - 1
        )
        if os.path.exists(p_out):
            xc = xi = y = None
        else:
            t0 = _time.perf_counter()
            with np.load(f"{prefix}_day_{i}.npz") as d:
                xct, xi, y = d["X_cat_t"], d["X_int"], d["y"]
            xc = np.empty((xct.shape[1], SPA), dtype=np.int32)
            for j in range(SPA):
                if db is not None:
                    xc[:, j] = db.remap(j, xct[j])
                else:
                    sorted_vals, ids = remaps[j]
                    pos = np.searchsorted(sorted_vals, xct[j])
                    xc[:, j] = ids[pos]
            xi = xi.copy()
            xi[xi < 0] = 0
            save(p_out, X_cat=xc, X_int=xi, y=y)
            stage_s["remap"] += _time.perf_counter() - t0
        if os.path.exists(r_out):
            continue
        t0 = _time.perf_counter()
        if xc is None:  # resuming past an existing processed file
            with np.load(p_out) as d:
                xc, xi, y = d["X_cat"], d["X_int"], d["y"]
        if want_shuffle:
            perm = rng.permutation(len(y))
            xc, xi, y = xc[perm], xi[perm], y[perm]
        save(r_out, X_cat=xc, X_int=xi, y=y)
        stage_s["shuffle"] += _time.perf_counter() - t0
    if db is not None:
        db.free()

    # optional: one concatenated file (Kaggle flow)
    if concat_output:
        t0 = _time.perf_counter()
        xs, ys, cs = [], [], []
        for i in range(days):
            with np.load(f"{prefix}_day_{i}_processed.npz") as d:
                cs.append(d["X_cat"])
                xs.append(d["X_int"])
                ys.append(d["y"])
        save(
            f"{concat_output}.npz",
            X_cat=np.concatenate(cs),
            X_int=np.concatenate(xs),
            y=np.concatenate(ys),
            counts=counts,
        )
        stage_s["concat"] = _time.perf_counter() - t0

    return {
        "counts": counts,
        "total_per_file": np.array(total_per_file),
        "stage_seconds": {k: round(v, 3) for k, v in stage_s.items()},
    }


# ---------------------------------------------------------------------------
# loading: reordered day files -> fixed-shape batches
# ---------------------------------------------------------------------------

def transform_dense(x_int: np.ndarray) -> np.ndarray:
    """log(x+1) dense transform (collate_wrapper_criteo,
    dlrm_data_pytorch.py:319-345)."""
    return np.log(x_int.astype(np.float32) + 1.0)


class CriteoNpzLoader:
    """Streams fixed-shape Batches from per-day ``*_reordered.npz`` files.

    Split semantics (dlrm_data_pytorch.py:54-345 / data_loader_terabyte.py):
    train = days 0..n-2; test = first half of last day; val = second half.
    """

    def __init__(
        self,
        prefix: str,
        days: int,
        batch_size: int,
        split: str = "train",
        max_ind_range: int = -1,
        drop_last: bool = True,
        memory_map: bool = False,
    ):
        self.prefix = prefix
        self.batch_size = batch_size
        self.split = split
        self.max_ind_range = max_ind_range
        self.drop_last = drop_last
        self.memory_map = memory_map
        if split == "train":
            self.day_range = list(range(days - 1))
        else:
            self.day_range = [days - 1]
        with np.load(f"{prefix}_day_count.npz") as d:
            per = d["total_per_file"]
        if split == "train":
            self.length = int(sum(per[:-1]))
        else:
            self.length = int(np.ceil(per[-1] / 2.0))

    def __len__(self):
        n, b = self.length, self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def _day_arrays(self, i):
        if self.memory_map:
            # uncompressed per-array .npy views (convert_days_to_memmap);
            # the reference's --memory-map path similarly builds per-feature
            # .npy memmaps (data_utils.py, SURVEY.md §2 #16)
            xc = np.load(f"{self.prefix}_day_{i}_X_cat.npy", mmap_mode="r")
            xi = np.load(f"{self.prefix}_day_{i}_X_int.npy", mmap_mode="r")
            y = np.load(f"{self.prefix}_day_{i}_y.npy", mmap_mode="r")
        else:
            with np.load(f"{self.prefix}_day_{i}_reordered.npz") as d:
                xc, xi, y = d["X_cat"], d["X_int"], d["y"]
        if self.split in ("test", "val"):
            mid = int(np.ceil(len(y) / 2.0))
            sl = slice(0, mid) if self.split == "test" else slice(mid, None)
            xc, xi, y = xc[sl], xi[sl], y[sl]
        return xc, xi, y

    def __iter__(self) -> Iterator[Batch]:
        b = self.batch_size
        carry = None  # leftover rows stitched across day boundaries
        for i in self.day_range:
            xc, xi, y = self._day_arrays(i)
            if carry is not None:
                xc = np.concatenate([carry[0], xc])
                xi = np.concatenate([carry[1], xi])
                y = np.concatenate([carry[2], y])
                carry = None
            n_full = len(y) // b * b
            for s in range(0, n_full, b):
                yield self._make_batch(
                    xi[s : s + b], xc[s : s + b], y[s : s + b]
                )
            if n_full < len(y):
                carry = (xc[n_full:], xi[n_full:], y[n_full:])
        if carry is not None and not self.drop_last:
            yield self._make_batch(carry[1], carry[0], carry[2])

    def _make_batch(self, xi, xc, y) -> Batch:
        cat = xc.astype(np.int64)
        if self.max_ind_range > 0:
            cat = cat % self.max_ind_range
        bsz = len(y)
        indices = np.ascontiguousarray(cat.T.reshape(SPA, bsz, 1)).astype(np.int32)
        return Batch(
            dense=transform_dense(xi),
            indices=indices,
            weights=np.ones((SPA, bsz, 1), dtype=np.float32),
            labels=y.reshape(-1, 1).astype(np.float32),
        )


def convert_days_to_memmap(prefix: str, days: int) -> None:
    """Unpack per-day reordered npz into raw .npy files so the loader can
    memory-map them (--memory-map; batches then read pages on demand instead
    of decompressing whole days into RAM — the capability the reference's
    1-TB-RAM-avoiding memmap flow provides, data_utils.py / SURVEY.md §2 #16).
    """
    for i in range(days):
        with np.load(f"{prefix}_day_{i}_reordered.npz") as d:
            np.save(f"{prefix}_day_{i}_X_cat.npy", d["X_cat"])
            np.save(f"{prefix}_day_{i}_X_int.npy", d["X_int"])
            np.save(f"{prefix}_day_{i}_y.npy", d["y"])
