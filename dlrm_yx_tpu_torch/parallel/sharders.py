"""Table -> model-shard placement algorithms.

A copy of ``dlrm_yx_tpu/parallel/sharders.py`` (the reference's
``sharders.py``): pluggable algorithms that give, for T tables, a shard id
per table (``shard(rows, ndevices, alg)``). ``naive`` (round-robin),
``naive_chunk`` (contiguous blocks), ``greedy`` (the least-loaded shard by
row count), ``hardcode``, and ``input`` (a placement given by the user,
the reference's --allocation flag, dlrm_s_pytorch.py:453-454).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

_SHARDERS: Dict[str, Callable] = {}


def register_sharder(name: str):
    def decorate(fn):
        _SHARDERS[name] = fn
        return fn
    return decorate


def get_splits(t: int, ndevices: int) -> List[int]:
    """Near-even split sizes of t items over ndevices (the first remainder
    devices get one extra)."""
    k, m = divmod(t, ndevices)
    return [(k + 1) if i < m else k for i in range(ndevices)]


def shard(
    rows: Sequence[int],
    ndevices: int,
    alg: str = "naive",
    allocation: Optional[Sequence[int]] = None,
) -> List[int]:
    """rows: per-table row counts (the load-balancing signal); returns a
    shard id per table."""
    if alg == "input":
        if allocation is None or len(allocation) != len(rows):
            raise ValueError("alg='input' requires an allocation of len(rows)")
        if any(not (0 <= d < ndevices) for d in allocation):
            raise ValueError("allocation contains out-of-range device ids")
        return list(allocation)
    if alg not in _SHARDERS:
        raise ValueError(f"sharder {alg!r} not found (have {sorted(_SHARDERS)})")
    return _SHARDERS[alg](list(rows), ndevices)


@register_sharder("naive")
def _naive(rows, ndevices):
    """Round-robin: table t -> t % ndevices."""
    return [t % ndevices for t in range(len(rows))]


@register_sharder("naive_chunk")
def _naive_chunk(rows, ndevices):
    """Contiguous near-even blocks."""
    out = []
    for dev, n in enumerate(get_splits(len(rows), ndevices)):
        out.extend([dev] * n)
    return out


@register_sharder("greedy")
def _greedy(rows, ndevices):
    """Each table to the currently least-loaded shard (load = total rows)."""
    buckets = [0] * ndevices
    out = []
    for n in rows:
        dev = buckets.index(min(buckets))
        buckets[dev] += n
        out.append(dev)
    return out


@register_sharder("hardcode")
def _hardcode(rows, ndevices):
    """First table on shard 0, the rest on shard 1 (a debug placement,
    sharders.py:55-60)."""
    if ndevices < 2:
        return [0] * len(rows)
    return [0] + [1] * (len(rows) - 1)
