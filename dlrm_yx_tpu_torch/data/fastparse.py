"""ctypes bindings for the native data-path code (``csrc/fastparse.cpp``).

A copy of ``dlrm_yx_tpu/data/fastparse.py``. The shared library is host
code, not a device kernel: ``g++`` builds it at first use (about a second)
into ``build/torch_kernels/`` at the root of the checkout (gitignored), under
a name that carries a hash of the source and the flags, as ``ops/_build.py``
names the CUDA kernels, so an edited source is rebuilt. Every entry point
has a numpy version in ``criteo.py`` / ``criteo_bin.py``, which the callers
take when no compiler is present (and which the tests hold the native code
to). ``calls`` counts the native parses and batch reads, so a caller can
show that the native path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fastparse.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# no -march=native: a build directory may move to a host with another CPU
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

DEN, SPA = 13, 26

# native calls so far, by entry point
calls: Dict[str, int] = {"parse_raw_tsv": 0, "read_bin_batch": 0}


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"fastparse-{key}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            so = lib_path()
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
                tmp.replace(so)
            lib = ctypes.CDLL(str(so))
            lib.fp_parse_raw_tsv.restype = ctypes.c_long
            lib.fp_parse_raw_tsv.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_double,
                ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.fp_count_lines.restype = ctypes.c_long
            lib.fp_count_lines.argtypes = [ctypes.c_char_p]
            lib.fp_read_bin_batch.restype = ctypes.c_long
            lib.fp_read_bin_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.fp_dict_new.restype = ctypes.c_void_p
            lib.fp_dict_new.argtypes = [ctypes.c_long]
            lib.fp_dict_free.argtypes = [ctypes.c_void_p]
            lib.fp_dict_update.restype = ctypes.c_long
            lib.fp_dict_update.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ]
            lib.fp_dict_size.restype = ctypes.c_long
            lib.fp_dict_size.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.fp_dict_uniques.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
            ]
            lib.fp_dict_remap.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_void_p,
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def available() -> bool:
    return _build() is not None


def parse_raw_tsv(
    path: str, max_ind_range: int = -1, sub_sample_rate: float = 0.0,
    seed: int = 123,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _build()
    assert lib is not None
    calls["parse_raw_tsv"] += 1
    n_max = lib.fp_count_lines(path.encode())
    if n_max < 0:
        raise IOError(f"cannot read {path}")
    y = np.zeros(n_max, dtype=np.int32)
    xi = np.zeros((n_max, DEN), dtype=np.int32)
    xc = np.zeros((n_max, SPA), dtype=np.int32)
    n = lib.fp_parse_raw_tsv(
        path.encode(), n_max, max_ind_range, sub_sample_rate, seed,
        y.ctypes.data, xi.ctypes.data, xc.ctypes.data,
    )
    if n < 0:
        raise IOError(f"parse failed for {path}")
    return y[:n].copy(), xi[:n].copy(), xc[:n].copy()


class DictBuilder:
    """Insertion-order categorical dictionaries over ``ncols`` columns —
    the hash-based replacement for the numpy sort-based dict/remap stages
    (one pass to build first-appearance dictionaries, O(1)/row remap).
    Wraps the C++ FlatMap handle; free() (or the GC) releases it."""

    def __init__(self, ncols: int):
        lib = _build()
        assert lib is not None
        self._lib = lib
        self._h = lib.fp_dict_new(ncols)
        self.ncols = ncols

    def update(self, j: int, col: np.ndarray) -> int:
        col = np.ascontiguousarray(col, dtype=np.int32)
        return self._lib.fp_dict_update(
            self._h, j, col.ctypes.data, len(col)
        )

    def size(self, j: int) -> int:
        return self._lib.fp_dict_size(self._h, j)

    def uniques(self, j: int) -> np.ndarray:
        out = np.empty(self.size(j), dtype=np.int32)
        self._lib.fp_dict_uniques(self._h, j, out.ctypes.data)
        return out

    def remap(self, j: int, col: np.ndarray) -> np.ndarray:
        col = np.ascontiguousarray(col, dtype=np.int32)
        out = np.empty(len(col), dtype=np.int32)
        self._lib.fp_dict_remap(
            self._h, j, col.ctypes.data, len(col), out.ctypes.data
        )
        return out

    def free(self):
        if self._h:
            self._lib.fp_dict_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


def read_bin_batch(
    path: str, batch_idx: int, batch_size: int, max_ind_range: int = -1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _build()
    assert lib is not None
    calls["read_bin_batch"] += 1
    y = np.zeros(batch_size, dtype=np.float32)
    dense = np.zeros((batch_size, DEN), dtype=np.float32)
    cat = np.zeros((batch_size, SPA), dtype=np.int32)
    rows = lib.fp_read_bin_batch(
        path.encode(), batch_idx, batch_size, max_ind_range,
        y.ctypes.data, dense.ctypes.data, cat.ctypes.data,
    )
    if rows < 0:
        raise IOError(f"bin read failed for {path}")
    return y[:rows], dense[:rows], cat[:rows]
