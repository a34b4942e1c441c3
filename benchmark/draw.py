"""Weights drawn from a run's seed, shared by the program's set-up and the
plain reference. Plain PyTorch and NumPy: nothing here imports the program.

Every draw is keyed by (seed, what, index) through ``numpy.random.SeedSequence``,
so any seed the benchmark is given (larger than 32 bits too) gives the same
values on every run, and the reference can draw again exactly the rows and
layers it needs.
"""

from __future__ import annotations

import numpy as np
import torch

# rows of one seeded draw of a table (512 MB at width 128). Frozen copy of
# chip_smoke.py:4749 (DRAW_BLOCK_ROWS).
DRAW_BLOCK_ROWS = 1 << 20

TOWER_KEY = 1_000_003  # keeps the towers' streams apart from the tables'


def stream_seed(*key: int) -> int:
    """A 63-bit generator seed from a key of whole numbers of any size."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def draw_block(seed: int, table: int, n_rows: int, dim: int, r0: int, r1: int,
               device) -> torch.Tensor:
    """Rows [r0, r1) of a table of ``n_rows`` rows: U(+-1/sqrt(n_rows)) in f32,
    the block of DRAW_BLOCK_ROWS rows that holds r0 drawn whole from its own
    generator, so a table's values depend on neither the mesh nor the rows
    asked for. [r0, r1) lies inside one block. Frozen copy of
    chip_smoke.py:5096-5109 (``draw_block``), with the seed, the table's
    rows and width as arguments."""
    block = r0 // DRAW_BLOCK_ROWS
    b0 = block * DRAW_BLOCK_ROWS
    b1 = min(n_rows, b0 + DRAW_BLOCK_ROWS)
    if not (b0 <= r0 < r1 <= b1):
        raise ValueError(f"rows [{r0}, {r1}) of a {n_rows}-row table cross a draw block")
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, table, block))
    bound = float(np.float32(np.sqrt(1.0 / n_rows)))
    rows = torch.empty((b1 - b0, dim), device=device).uniform_(-bound, bound, generator=gen)
    return rows[r0 - b0: r1 - b0]


def table_blocks(n_rows: int):
    """The [r0, r1) draw blocks of a table."""
    return [(r0, min(n_rows, r0 + DRAW_BLOCK_ROWS)) for r0 in range(0, n_rows, DRAW_BLOCK_ROWS)]


def draw_rows(seed: int, table: int, n_rows: int, dim: int, ids: torch.Tensor) -> torch.Tensor:
    """[len(ids), dim] f32: the drawn rows ``ids`` (int64, any order) of a table,
    on the device of ``ids``, drawing only the blocks they fall in."""
    out = torch.empty((ids.numel(), dim), device=ids.device)
    block_of = ids // DRAW_BLOCK_ROWS
    for block in torch.unique(block_of).tolist():
        r0 = block * DRAW_BLOCK_ROWS
        r1 = min(n_rows, r0 + DRAW_BLOCK_ROWS)
        sel = (block_of == block).nonzero().reshape(-1)
        out[sel] = draw_block(seed, table, n_rows, dim, r0, r1, ids.device)[ids[sel] - r0]
    return out


def draw_tower(seed: int, tower: int, sizes, device):
    """[(W [n, m], b [m])] f32 for each layer n -> m of an MLP: W ~ N(0,
    sqrt(2 / (n + m))), b ~ N(0, sqrt(1 / m)), the distribution of the
    reference DLRM's initialiser (dlrm_s_pytorch.py:create_mlp), each layer
    from its own generator on the device."""
    layers = []
    for i in range(len(sizes) - 1):
        n, m = int(sizes[i]), int(sizes[i + 1])
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, TOWER_KEY, tower, i))
        w = torch.randn((n, m), device=device, generator=gen).mul_(float(np.sqrt(2.0 / (n + m))))
        b = torch.randn((m,), device=device, generator=gen).mul_(float(np.sqrt(1.0 / m)))
        layers.append((w, b))
    return layers
