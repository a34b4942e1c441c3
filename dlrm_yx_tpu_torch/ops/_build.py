"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so <name>.cu

A kernel may include a shared ``csrc/*.cuh`` header. The library name
carries a hash of the source, the headers and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is. The build
directory sits at the root of the checkout and is listed in ``.gitignore``.
Nothing is built when a module is imported: a kernel's wrapper calls
``load`` at its first launch on a CUDA tensor.

``zeroed_scratch`` keeps the scratch of the kernels that leave it as the
next call needs it (the row plan of K2 and K4 leaves it zero where it reads
before it writes; K5's compaction writes before it reads, and resets its
ticket), one buffer per kernel, device and size. ``device_counts`` keeps
the counts a kernel adds to on the device (the row plan's tail: its
duplicated items, runs and long runs), one buffer per kernel and device,
read only when ``counts_of`` is asked.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_scratch: Dict[tuple, "torch.Tensor"] = {}
_counts: Dict[tuple, "torch.Tensor"] = {}
# nvcc's output (ptxas register / shared-memory report) per built kernel
build_logs: Dict[str, str] = {}


def kernel_names() -> Tuple[str, ...]:
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (on PATH or under CUDA_HOME): the port's CUDA "
        "kernels are built on the machine with the card"
    )


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: Sequence[str] = ()) -> float:
    """Compile the named kernels (all of ``csrc/`` by default) that are not
    built yet, one nvcc per source, all started together. Returns the
    seconds taken; raises with nvcc's output if a build fails."""
    t0 = time.perf_counter()
    names = tuple(names) or kernel_names()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def zeroed_scratch(name: str, device, nbytes: int):
    """A cached uint8 buffer of ``nbytes`` on ``device`` for kernel ``name``,
    zero when it is made; the kernel must leave it zero after each call.
    Made by the first call, which must not run inside a CUDA graph capture
    (the zero fill would only be recorded, not run)."""
    import torch

    key = (name, device, nbytes)
    buf = _scratch.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: call it once before capturing it in a CUDA graph "
                               "(its scratch is made and zeroed at the first call)")
        buf = _scratch[key] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    return buf


def device_counts(name: str, device, n: int):
    """A cached int64 buffer of ``n`` counts on ``device`` that kernel
    ``name`` adds to at each call, zero when it is made. Made by the first
    call, which must not run inside a CUDA graph capture."""
    import torch

    key = (name, device)
    buf = _counts.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: call it once before capturing it in a CUDA graph "
                               "(its counts are made at the first call)")
        buf = _counts[key] = torch.zeros(n, dtype=torch.int64, device=device)
    return buf


def counts_of(names: Sequence[str]):
    """The sum of the device counts of the kernels ``names`` over every
    device, as a list of ints (one copy to the host a device), or None
    where none of them has run on a card."""
    bufs = [b for (name, _), b in _counts.items() if name in names]
    if not bufs:
        return None
    return [sum(int(v) for v in col) for col in zip(*(b.tolist() for b in bufs))]
