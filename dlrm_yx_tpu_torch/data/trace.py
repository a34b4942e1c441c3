"""Trace-driven synthetic index generation via stack-distance distributions.

A copy of ``dlrm_yx_tpu/data/trace.py``: the same batches from the same
seed and distribution files.

Capability parity with the reference's cache-style synthetic generator
(``dlrm_data_pytorch.py:1306-1484``), which implements the
stack-distance model of Hassan et al. (AINAM'07): profile a trace into
(unique line accesses, stack-distance CDF), then regenerate statistically
similar traces with an LRU stack.

File formats kept byte-compatible:
  * dist file: 3 CSV lines — unique accesses / stack-distance values /
    cumulative probabilities (``input/dist_emb_j.log`` fixtures);
  * trace file: one CSV line of uint64 (or flat binary uint64).
"""

from __future__ import annotations

import bisect
import os
from collections import deque
from typing import List, Sequence, Tuple

import numpy as np


def trace_profile(trace: Sequence[int]) -> Tuple[List[int], List[int], List[int]]:
    """LRU-stack profile of a trace.

    Returns (final_stack, stack_distances, line_accesses):
      * stack_distances[k]: distance of the k-th access counted FROM THE END
        of the trace (the reference appends left); 0 = first-time access;
      * line_accesses: first-touch order of unique lines, newest first.
    """
    stack: deque = deque()
    distances: deque = deque()
    first_touch: deque = deque()
    for x in trace:
        x = int(x)
        try:
            i = stack.index(x)
            distances.appendleft(len(stack) - i)
            del stack[i]
        except ValueError:
            distances.appendleft(0)
            first_touch.appendleft(x)
        stack.append(x)
    return list(stack), list(distances), list(first_touch)


def dist_from_distances(distances: Sequence[int]) -> Tuple[List[int], List[float]]:
    """Histogram stack distances into (values, cumulative probabilities)."""
    vals, counts = np.unique(np.asarray(distances, dtype=np.int64), return_counts=True)
    cum = np.cumsum(counts) / float(len(distances))
    return vals.tolist(), [round(float(c), 10) for c in cum]


def sample_stack_distance(
    rng, list_sd: Sequence[int], cumm_sd: Sequence[float], max_sd: int,
    seen: int, enable_padding: bool = False,
) -> int:
    """Draw one stack distance from the CDF; distances are capped at the
    number of distinct lines seen so far (can't re-reference deeper than the
    current stack), matching generate_stack_distance semantics
    (dlrm_data_pytorch.py:1306-1324)."""
    u = float(rng.rand(1)[0])
    if seen < max_sd:
        j = bisect.bisect(list_sd, seen) - 1
        u *= cumm_sd[j]
    elif enable_padding:
        f0 = cumm_sd[0]
        u = (1.0 - f0) * u + f0
    for j, f in enumerate(cumm_sd):
        if u <= f:
            return list_sd[j]
    return list_sd[-1]


def trace_generate_lru(
    line_accesses: List[int],
    list_sd: Sequence[int],
    cumm_sd: Sequence[float],
    out_trace_len: int,
    rng=None,
    enable_padding: bool = False,
) -> List[int]:
    """Regenerate a trace with LRU-stack semantics: distance 0 pops the next
    unseen line; distance d re-references the d-th line from the stack top
    and promotes it. Mutates line_accesses (pass a copy to preserve)."""
    rng = rng or np.random
    max_sd = list_sd[-1]
    n = len(line_accesses)
    seen = 0
    out: List[int] = []
    for _ in range(out_trace_len):
        sd = sample_stack_distance(rng, list_sd, cumm_sd, max_sd, seen, enable_padding)
        if sd == 0:
            ref = line_accesses.pop(0)
            line_accesses.append(ref)
            seen += 1
        else:
            ref = line_accesses[n - sd]
            del line_accesses[n - sd]
            line_accesses.append(ref)
        out.append(int(ref))
    return out


def trace_generate_rand(
    line_accesses: List[int],
    list_sd: Sequence[int],
    cumm_sd: Sequence[float],
    out_trace_len: int,
    rng=None,
    enable_padding: bool = False,
) -> List[int]:
    """Like trace_generate_lru but without stack promotion on re-reference
    (the reference's 'rand' variant, dlrm_data_pytorch.py:1356-1378)."""
    rng = rng or np.random
    max_sd = list_sd[-1]
    n = len(line_accesses)
    seen = 0
    out: List[int] = []
    for _ in range(out_trace_len):
        sd = sample_stack_distance(rng, list_sd, cumm_sd, max_sd, seen, enable_padding)
        if sd == 0:
            ref = line_accesses.pop(0)
            line_accesses.append(ref)
            seen += 1
        else:
            ref = line_accesses[n - sd]
        out.append(int(ref))
    return out


# --- file IO (byte-compatible with input/dist_emb_j.log / trace.log) --------

def read_dist_file(path: str) -> Tuple[List[int], List[int], List[float]]:
    with open(path) as f:
        lines = f.read().splitlines()
    uniques = [int(x) for x in lines[0].split(", ")]
    list_sd = [int(x) for x in lines[1].split(", ")]
    cumm_sd = [float(x) for x in lines[2].split(", ")]
    return uniques, list_sd, cumm_sd


def write_dist_file(path: str, uniques, list_sd, cumm_sd) -> None:
    with open(path, "w") as f:
        for row in (list(uniques), list(list_sd), list(cumm_sd)):
            s = str(row)
            f.write(s[1:-1] + "\n")


def read_trace_file(path: str, binary: bool = False) -> List[int]:
    if binary:
        return np.fromfile(path, dtype=np.uint64).tolist()
    with open(path) as f:
        return [int(x) for x in f.readline().split(", ")]


def write_trace_file(path: str, trace, binary: bool = False) -> None:
    if binary:
        np.asarray(trace, dtype=np.uint64).tofile(path)
    else:
        with open(path, "w") as f:
            s = str(list(trace))
            f.write(s[1:-1])


def make_trace_batches(
    dist_file_pattern: str,
    emb_rows: Sequence[int],
    m_den: int,
    mini_batch_size: int,
    num_batches: int,
    num_indices_per_lookup: int,
    num_indices_per_lookup_fixed: bool = False,
    seed: int = 123,
    enable_padding: bool = False,
):
    """Batches whose sparse indices follow per-table stack-distance
    distributions (the reference's --data-generation=synthetic path,
    generate_synthetic_input_batch, dlrm_data_pytorch.py:1232-1304). The
    pattern's 'j' is replaced with the table id; out-of-range ids are
    wrapped with mod like the reference."""
    from dlrm_yx_tpu_torch.data.batch import Batch

    rng = np.random.RandomState(seed)
    t = len(emb_rows)
    l = num_indices_per_lookup
    # ONE persistent LRU line-access list per table, mutated across the
    # whole stream — the reference threads the same line_accesses list
    # through every generate call (dlrm_data_pytorch.py:1268-1304); a
    # fresh copy per sample would reset the stack and degenerate the
    # stream to the stack-top element
    # count consecutive per-table files present, then wrap table ids over
    # them (e.g. 26 tables over the 3 shipped dist_emb_{0,1,2} fixtures)
    n_avail = 0
    while n_avail < t and os.path.exists(
        dist_file_pattern.replace("j", str(n_avail))
    ):
        n_avail += 1
    dists = []
    for k in range(t):
        uniques, list_sd, cumm_sd = read_dist_file(
            dist_file_pattern.replace("j", str(k % max(n_avail, 1)))
        )
        dists.append((list(uniques), list_sd, cumm_sd))
    batches = []
    for _ in range(num_batches):
        dense = rng.rand(mini_batch_size, m_den).astype(np.float32)
        indices = np.zeros((t, mini_batch_size, l), dtype=np.int32)
        weights = np.zeros((t, mini_batch_size, l), dtype=np.float32)
        for k, size in enumerate(emb_rows):
            uniques, list_sd, cumm_sd = dists[k]
            for b in range(mini_batch_size):
                if num_indices_per_lookup_fixed:
                    gs = l
                else:
                    gs = int(max(1, round(float(rng.rand(1)[0]) * min(size, l))))
                refs = trace_generate_lru(
                    uniques, list_sd, cumm_sd, gs, rng, enable_padding
                )
                group = np.unique(refs).astype(np.int64)
                if group.min(initial=0) < 0 or group.max(initial=0) >= size:
                    group = np.mod(group, size)
                    group = np.unique(group)
                m = min(len(group), l)
                indices[k, b, :m] = group[:m]
                weights[k, b, :m] = 1.0
        labels = rng.rand(mini_batch_size, 1).astype(np.float32)
        batches.append(Batch(dense, indices, weights, labels))
    return batches


def main(argv=None):
    """CLI mirroring the reference's synthetic-distribution generator
    (``dlrm_data_pytorch.py:1487-1552``): profile a trace
    into a stack-distance distribution file, then regenerate a synthetic
    trace from it via the LRU stack (Hassan et al. AINAM'07)."""
    import argparse

    import numpy as np

    p = argparse.ArgumentParser(description="Generate Synthetic Distributions")
    p.add_argument("--trace-file", type=str, default="./input/trace.log")
    p.add_argument("--trace-file-binary-type", type=bool, default=False)
    p.add_argument("--trace-enable-padding", type=bool, default=False)
    p.add_argument("--dist-file", type=str, default="./input/dist.log")
    p.add_argument("--synthetic-file", type=str,
                   default="./input/trace_synthetic.log")
    p.add_argument("--numpy-rand-seed", type=int, default=123)
    p.add_argument("--print-precision", type=int, default=5)
    args = p.parse_args(argv)
    np.random.seed(args.numpy_rand_seed)
    np.set_printoptions(precision=args.print_precision)

    trace = read_trace_file(args.trace_file, args.trace_file_binary_type)
    uniques, distances, _ = trace_profile(trace)
    list_sd, cumm_sd = dist_from_distances(distances)
    write_dist_file(args.dist_file, uniques, list_sd, cumm_sd)
    synthetic = trace_generate_lru(
        uniques, list_sd, cumm_sd, len(trace),
        enable_padding=args.trace_enable_padding,
    )
    write_trace_file(args.synthetic_file, synthetic,
                     args.trace_file_binary_type)
    print(f"profiled {len(trace)} accesses -> {args.dist_file} "
          f"({len(uniques)} uniques); synthetic -> {args.synthetic_file}")


if __name__ == "__main__":
    main()
