"""The program's parameters, drawn on its device from the run's seed.

The values are ``benchmark.draw``'s, which the reference draws again; this
module lays them out as the port keeps them (``models.dlrm``: the towers
as ``(W [in, out], b)`` pairs, one store a table group, each table at its
row offset, padding rows zero). The port's own initialisers draw on the
host (``init_dlrm``) or from other streams (``init_dlrm_on_device``).
"""

from __future__ import annotations

import torch

from benchmark.draw import draw_block, draw_tower, table_blocks


def model_params(config, seed: int, device) -> dict:
    """The params dict of ``config`` (plain f32 tables only)."""
    from dlrm_yx_tpu_torch.models.dlrm import model_groups

    if (config.qr_table_ids or config.md_table_ids or config.weighted_pooling
            or config.emb_dtype != "float32"):
        raise NotImplementedError("the benchmark draws plain f32 tables only")
    dev = torch.device(device)
    emb = []
    for g in model_groups(config):
        store = torch.zeros((g.total_rows, g.dim), dtype=torch.float32, device=dev)
        for t, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            for r0, r1 in table_blocks(n):
                store[off + r0: off + r1] = draw_block(seed, t, n, g.dim, r0, r1, dev)
        emb.append(store)
    return {"bot": draw_tower(seed, 0, config.ln_bot, dev),
            "top": draw_tower(seed, 1, config.ln_top, dev), "emb": emb, "vw": None}


def table_places(groups) -> dict:
    """table id -> (group index, first store row)."""
    return {t: (gi, off) for gi, g in enumerate(groups)
            for t, off in zip(g.table_ids, g.row_offsets)}
