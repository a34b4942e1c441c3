"""Flat-binary Criteo dataset: converter + random-access batch loader.

A copy of ``dlrm_yx_tpu/data/criteo_bin.py``. Capability parity with
``CriteoBinDataset`` / ``numpy_to_binary`` in the reference's
``data_loader_terabyte.py:205-312``, byte-compatible format: one record per
sample = 40 little-endian int32 = [y, 13 x X_int, 26 x X_cat]; one
seek+read per batch; test/val = first/second half of the last day's file.
The last batch is short when the file is not a whole number of batches.

The native reader (``fp_read_bin_batch`` in ``csrc/fastparse.cpp``, via
``fastparse``) does the pread + int32→float transform off the GIL; the
numpy path is its plain version (``use_native=False``).

As in the JAX package, ``counts_file`` is read with ``np.load``: the
reference's MLPerf command line (``bench/run_and_time.sh``) passes its test
``.bin`` there through ``--processed-data-file``, and ``np.load`` raises
``ValueError`` on it (ROADMAP Queue C keeps the fault as the reference has
it).
"""

from __future__ import annotations

import math
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.data.criteo import DEN, SPA, transform_dense

TOT = 1 + DEN + SPA  # 40 int32 per record


def npz_to_binary(
    input_files: Sequence[str], output_path: str, split: str = "train"
) -> None:
    """Convert processed/reordered npz day files to the flat int32 binary.
    split='train' concatenates all inputs; 'test'/'val' take the first/second
    half of a single input (numpy_to_binary, data_loader_terabyte.py:255-293).
    """
    with open(output_path, "wb") as out:
        if split == "train":
            for f in input_files:
                with np.load(f) as d:
                    rec = np.concatenate(
                        [d["y"].reshape(-1, 1), d["X_int"], d["X_cat"]], axis=1
                    ).astype(np.int32)
                out.write(rec.tobytes())
        else:
            assert len(input_files) == 1
            with np.load(input_files[0]) as d:
                rec = np.concatenate(
                    [d["y"].reshape(-1, 1), d["X_int"], d["X_cat"]], axis=1
                ).astype(np.int32)
            mid = int(np.ceil(rec.shape[0] / 2.0))
            part = rec[:mid] if split == "test" else rec[mid:]
            out.write(part.tobytes())


class CriteoBinLoader:
    """Random-access batches from the flat binary file.

    Each __getitem__(i) is one seek+read of batch_size records — the
    reference's one-syscall-per-batch property — decoded to the framework's
    fixed-shape Batch (L=1)."""

    def __init__(
        self,
        data_file: str,
        counts_file: Optional[str] = None,
        batch_size: int = 2048,
        max_ind_range: int = -1,
        use_native: bool = True,
        shuffle_seed: Optional[int] = None,
    ):
        self.batch_size = batch_size
        self.max_ind_range = max_ind_range
        self.bytes_per_batch = 4 * TOT * batch_size
        self.num_batches = math.ceil(os.path.getsize(data_file) / self.bytes_per_batch)
        self.data_file = data_file
        self.file = open(data_file, "rb")
        # --mlperf-bin-shuffle: permute BATCH read order with a seeded RNG
        # (the reference shuffles the bin loader's batch order,
        # dlrm_data_pytorch.py:383-398); reshuffle(epoch) re-permutes
        self._shuffle_seed = shuffle_seed
        self._order = None
        if shuffle_seed is not None:
            self.reshuffle(0)
        self.counts = None
        if counts_file is not None:
            with np.load(counts_file) as d:
                self.counts = d["counts"]
        self._native = None
        if use_native:
            try:
                from dlrm_yx_tpu_torch.data import fastparse

                if fastparse.available():
                    self._native = fastparse
            except Exception:
                self._native = None

    def __len__(self):
        return self.num_batches

    def reshuffle(self, epoch: int) -> None:
        """New deterministic batch-order permutation for the given epoch."""
        rng = np.random.RandomState((self._shuffle_seed or 0) + epoch)
        self._order = rng.permutation(self.num_batches)

    def __getitem__(self, idx: int) -> Batch:
        if self._order is not None:
            idx = int(self._order[idx])
        if self._native is not None:
            y, xi, xc = self._native.read_bin_batch(
                self.data_file, idx, self.batch_size, self.max_ind_range
            )
            bsz = len(y)
            return Batch(
                dense=xi,
                indices=np.ascontiguousarray(xc.T.reshape(SPA, bsz, 1)),
                weights=np.ones((SPA, bsz, 1), dtype=np.float32),
                labels=y.reshape(-1, 1),
            )
        self.file.seek(idx * self.bytes_per_batch, 0)
        raw = self.file.read(self.bytes_per_batch)
        arr = np.frombuffer(raw, dtype=np.int32).reshape(-1, TOT)
        y = arr[:, 0].astype(np.float32).reshape(-1, 1)
        dense = transform_dense(arr[:, 1 : 1 + DEN])
        cat = arr[:, 1 + DEN :].astype(np.int64)
        if self.max_ind_range > 0:
            cat = cat % self.max_ind_range
        bsz = arr.shape[0]
        return Batch(
            dense=dense,
            indices=np.ascontiguousarray(cat.T.reshape(SPA, bsz, 1)).astype(np.int32),
            weights=np.ones((SPA, bsz, 1), dtype=np.float32),
            labels=y,
        )

    def __iter__(self) -> Iterator[Batch]:
        for i in range(self.num_batches):
            yield self[i]

    def __del__(self):
        try:
            self.file.close()
        except Exception:
            pass
