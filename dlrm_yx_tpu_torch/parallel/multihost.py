"""Joining a multi-process world, and starting one on this host.

The port of ``dlrm_yx_tpu/parallel/multihost.py`` (the reference's
``extend_distributed.py:39-207``): ``init_multihost`` finds the rank and
world size in the launcher's env vars, in the JAX package's order
(``NUM_PROCESSES``, ``WORLD_SIZE``, ``PMI_SIZE``, ``OMPI_COMM_WORLD_SIZE``;
``PROCESS_ID``, ``RANK``, ``PMI_RANK``, ``OMPI_COMM_WORLD_RANK``), and the
rendezvous in ``COORDINATOR_ADDRESS`` (``host:port``), else ``MASTER_ADDR``
/ ``MASTER_PORT``, and initializes ``torch.distributed``: NCCL on the card,
gloo on the CPU. On one host with no such env it returns ``(0, 1)`` and
initializes nothing. Each rank's device is ``cuda:LOCAL_RANK``
(``local_device``) unless the caller asks for the CPU; it is made the
rank's current device before the process group exists, so that NCCL's
communicators and every bare ``"cuda"`` allocation land on it. A
collective that waits past ``TIMEOUT_S`` fails the rank with torch's
message instead of hanging the world.

``spawn_local`` starts a world of N processes on localhost (a free port,
one thread each, every child killed when one fails or the time runs out):
the CLI's ``--force-cpu-devices N``, and the tests' gloo worlds.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# how long a collective may wait for the other ranks (torch's NCCL default;
# gloo's is 30 min)
TIMEOUT_S = 600.0


def _env_int(names: Sequence[str], default: int = -1) -> int:
    """First integer found among env var names (extend_distributed.env2int)."""
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return default


def local_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: the CPU when asked for, else ``cuda:LOCAL_RANK``
    (0 when unset)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int(["LOCAL_RANK"], 0))
    return dev


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the multi-process world; returns (rank, world size). On one host
    with no launcher env it returns (0, 1), as the reference's
    init_distributed falls back to one process. ``backend`` defaults to
    NCCL for a CUDA ``device`` and gloo for the CPU; TIMEOUT_S bounds every
    collective's wait, the first one's rendezvous included."""
    num = (num_processes if num_processes is not None else
           _env_int(["NUM_PROCESSES", "WORLD_SIZE", "PMI_SIZE", "OMPI_COMM_WORLD_SIZE"], -1))
    pid = (process_id if process_id is not None else
           _env_int(["PROCESS_ID", "RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK"], -1))
    coord = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num in (-1, 0, 1) and coord is None:
        return 0, 1  # single host
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num < 1 or pid < 0:
        raise ValueError(f"a multi-process world needs its size and this process's rank "
                         f"(found {num} and {pid} in the launcher's env vars)")
    if coord is None:
        coord = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ['MASTER_PORT']}"
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=num, rank=pid,
                            timeout=timedelta(seconds=TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this process's slice of the global batch (the
    reference's per-rank batch slicing, dlrm_s_pytorch.py:139-143,
    1902-1904)."""
    rank, n = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    size = global_batch // n
    return rank * size, size


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(argv: List[str], n: int, timeout: Optional[float] = None,
                env: Optional[Dict[str, str]] = None, capture: bool = False):
    """Run ``argv`` (a command line after ``python``) as ranks 0..n-1 of a
    world on localhost: each child gets ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` / ``MASTER_PORT`` (a free port), one CPU thread, and the
    repository on its path. Waits for all; the first child to fail, or the
    ``timeout`` (seconds) running out, kills the others and raises
    ``RuntimeError`` with what the children printed (when ``capture``).
    Returns the children's outputs (None each without ``capture``)."""
    port = free_port()
    procs = []
    for rank in range(n):
        e = dict(os.environ if env is None else env)
        e.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join([REPO_ROOT] + [p for p in (e.get("PYTHONPATH"),) if p]))
        e.pop("COORDINATOR_ADDRESS", None)
        procs.append(subprocess.Popen(
            [sys.executable] + list(argv), env=e, cwd=REPO_ROOT,
            stdout=subprocess.PIPE if capture else None,
            stderr=subprocess.STDOUT if capture else None, text=True))
    deadline = None if timeout is None else time.monotonic() + timeout
    outs: List[Optional[str]] = [None] * n
    failed = None
    try:
        pending = set(range(n))
        while pending:
            for i in sorted(pending):
                p = procs[i]
                if capture:
                    try:
                        outs[i], _ = p.communicate(timeout=0.2)
                    except subprocess.TimeoutExpired:
                        pass
                elif p.poll() is None:
                    time.sleep(0.05)
                if p.poll() is not None:
                    pending.discard(i)
                    if p.returncode != 0 and failed is None:
                        failed = (i, f"exited with code {p.returncode}")
            if failed is not None:
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = (min(pending), f"did not finish within {timeout} s")
                break
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            if capture and outs[i] is None:
                outs[i], _ = p.communicate()
            else:
                p.wait()
    if failed is not None:
        rank, why = failed
        shown = "".join(f"\n--- rank {i} ---\n{o}" for i, o in enumerate(outs) if o)
        raise RuntimeError(f"rank {rank} of the local world {why}{shown}")
    return outs
