"""The DLRM model: bottom MLP + embedding lookups + interaction + top MLP.

The port of ``dlrm_yx_tpu/models/dlrm.py``. The functions keep the JAX
package's shape: parameters are a dict

    {"bot": [(W [in, out], b), ...], "top": [(W, b), ...],
     "emb": [store [total_rows, dim] per group, ...]}

and the forward is split at the pooled-embedding boundary
(``forward_from_pooled``) as it is there. ``DLRM`` is the ``nn.Module``
that owns such a dict as registered parameters (so ``state_dict``,
``parameters`` and ``to`` work) and runs ``forward_logits``.

Not yet ported: QR and MD embeddings and weighted pooling; a config that
asks for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.ops.embedding import (
    TableGroup,
    build_table_groups,
    device_ints,
    lookup_group,
)
from dlrm_yx_tpu_torch.ops.interaction import interact_features
from dlrm_yx_tpu_torch.ops.losses import predictions_from_logits
from dlrm_yx_tpu_torch.ops.mlp import apply_mlp, init_mlp
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.profiling import phase_scope

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# rows drawn per numpy call in init_dlrm: the draws are the same as one
# call per table (uniform draws are sequential in C order), without a
# float64 temporary of a whole 1M-row table
_INIT_CHUNK_ROWS = 1 << 16
# rows drawn per torch.rand call in init_dlrm_on_device (512 MB of f32 at dim 128)
_DEVICE_CHUNK_ROWS = 1 << 20


def model_groups(config: DLRMConfig) -> List[TableGroup]:
    """(dim, size-class)-groups over the regular (non-QR) tables."""
    return build_table_groups(
        config.emb_rows, config.emb_dims, config.regular_table_ids,
        small_threshold=config.emb_split_threshold or None,
    )


def check_supported(config: DLRMConfig) -> None:
    if config.qr_flag:
        raise NotImplementedError("QR embeddings are not yet ported")
    if config.md_table_ids:
        raise NotImplementedError("mixed-dimension embeddings are not yet ported")
    if config.weighted_pooling is not None:
        raise NotImplementedError("weighted pooling is not yet ported")


def _dense_params(rng: np.random.RandomState, config: DLRMConfig,
                  device: torch.device) -> Dict:
    def to_dev(layers):
        return [(torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
                for w, b in layers]

    bot = to_dev(init_mlp(rng, config.ln_bot))
    return {"bot": bot, "top": to_dev(init_mlp(rng, config.ln_top))}


def init_dlrm(config: DLRMConfig, seed: int = 123,
              device: Optional[Union[str, torch.device]] = None) -> Dict:
    """All parameters from one numpy RandomState, in the JAX package's draw
    order: embedding tables in canonical table order (U(-1/sqrt n, 1/sqrt n),
    padding rows zero), then the bottom MLP, then the top MLP. The values
    equal ``dlrm_yx_tpu.models.dlrm.init_dlrm``'s for the same seed. Each
    table is drawn straight into its group store's row block, so the host
    holds the stores once."""
    check_supported(config)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    groups = model_groups(config)
    stores = [np.zeros((g.total_rows, g.dim), dtype=np.float32) for g in groups]
    where = {
        t: (gi, off)
        for gi, g in enumerate(groups)
        for t, off in zip(g.table_ids, g.row_offsets)
    }
    for t, (n, d) in enumerate(zip(config.emb_rows, config.emb_dims)):
        gi, off = where[t]
        bound = np.sqrt(1.0 / n)
        for r0 in range(0, n, _INIT_CHUNK_ROWS):
            r1 = min(n, r0 + _INIT_CHUNK_ROWS)
            stores[gi][off + r0 : off + r1] = rng.uniform(
                -bound, bound, size=(r1 - r0, d)
            ).astype(np.float32)
    edt = DTYPES[config.emb_dtype]
    emb = [torch.from_numpy(s).to(dev).to(edt) for s in stores]
    del stores
    return {**_dense_params(rng, config, dev), "emb": emb}


def init_dlrm_on_device(config: DLRMConfig, seed: int = 123,
                        device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Large-model initializer: embedding stores are drawn on the device
    with a ``torch.Generator`` (seeded ``seed + group index``), so the
    tables never exist on the host. Same distribution as ``init_dlrm``
    (U(-1/sqrt n, 1/sqrt n) per table, zero padding rows), other values.
    Each table is drawn in f32 blocks of ``_DEVICE_CHUNK_ROWS`` rows cast
    into the store, so the device holds the store and one block (a bf16
    store of 13.8 GB never has an f32 twin). The dense params take the
    numpy draws that the JAX package's ``init_dlrm_on_device`` takes."""
    check_supported(config)
    dev = resolve_device(device)
    edt = DTYPES[config.emb_dtype]
    emb = []
    for gi, g in enumerate(model_groups(config)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + gi)
        store = torch.zeros((g.total_rows, g.dim), dtype=edt, device=dev)
        for n, off in zip(g.rows, g.row_offsets):
            bound = float(np.float32(np.sqrt(1.0 / n)))
            for r0 in range(0, n, _DEVICE_CHUNK_ROWS):
                r1 = min(n, r0 + _DEVICE_CHUNK_ROWS)
                block = torch.rand((r1 - r0, g.dim), generator=gen, device=dev)
                store[off + r0 : off + r1] = block.mul_(2.0).sub_(1.0).mul_(bound)
        emb.append(store)
    return {**_dense_params(np.random.RandomState(seed), config, dev), "emb": emb}


class DLRM(nn.Module):
    """Owns a parameter dict (see the module docstring) and computes click
    logits [B, 1] from (dense [B, m_den], indices [T, B, L], weights
    [T, B, L])."""

    def __init__(self, config: DLRMConfig, params: Dict):
        super().__init__()
        self.config = config
        self.groups = model_groups(config)
        self.bot_w = nn.ParameterList([w for w, _ in params["bot"]])
        self.bot_b = nn.ParameterList([b for _, b in params["bot"]])
        self.top_w = nn.ParameterList([w for w, _ in params["top"]])
        self.top_b = nn.ParameterList([b for _, b in params["top"]])
        # the stores are updated row-sparsely by hand, never by autograd
        self.emb = nn.ParameterList(
            [nn.Parameter(s, requires_grad=False) for s in params["emb"]]
        )

    def as_params(self) -> Dict:
        return {
            "bot": list(zip(self.bot_w, self.bot_b)),
            "top": list(zip(self.top_w, self.top_b)),
            "emb": list(self.emb),
        }

    def forward(self, dense_x, indices, weights):
        return forward_logits(
            self.as_params(), self.config, self.groups, dense_x, indices, weights
        )


def group_indices(group: TableGroup, indices: torch.Tensor) -> torch.Tensor:
    """Select this group's tables from canonical [T, B, L] inputs."""
    ids = group.table_ids
    if ids == tuple(range(indices.shape[0])):
        return indices
    return indices.index_select(0, device_ints(ids, indices.device))


def lookup_all_groups(
    params: Dict,
    groups: Sequence[TableGroup],
    indices: torch.Tensor,
    weights: torch.Tensor,
    want_rows: bool = False,
):
    """Pooled lookups for every group: [pooled_g [T_g, B, dim_g]]. With
    ``want_rows`` also the gathered rows per group ([T_g, B, dim_g] f32
    for an L=1 group, else None), which the write-only sparse update
    reuses."""
    pooled, rows = [], []
    with phase_scope("embedding_lookup"):
        for gi, g in enumerate(groups):
            idx_g = group_indices(g, indices)
            rows_ok = want_rows and idx_g.shape[2] == 1
            res = lookup_group(params["emb"][gi], g, idx_g,
                               group_indices(g, weights), return_rows=rows_ok)
            pooled.append(res[0] if rows_ok else res)
            rows.append(res[1] if rows_ok else None)
    return (pooled, rows) if want_rows else pooled


def assemble_slots(
    pooled_list: Sequence[torch.Tensor],
    groups: Sequence[TableGroup],
    config: DLRMConfig,
) -> torch.Tensor:
    """Reassemble group pooled outputs into [B, S, D] canonical slot order,
    applying the split trick (dim k*D -> k slots of D;
    dlrm_s_pytorch.py:579-585). When every table is one slot of dim D (the
    Criteo configs) it is one concat and one row gather (none for a single
    group), returned as a transposed view that the fused interaction reads
    without a copy; the backward is then one scatter, not one per table."""
    d = config.base_dim
    if all(g.dim == d for g in groups) and all(k == 1 for k in config.slots_per_table):
        order = [t for g in groups for t in g.table_ids]
        t = pooled_list[0] if len(groups) == 1 else torch.cat(list(pooled_list), 0)
        if order != sorted(order):
            where = {tid: i for i, tid in enumerate(order)}
            perm = tuple(where[tid] for tid in range(config.num_tables))
            t = t.index_select(0, device_ints(perm, t.device))
        return t.transpose(0, 1)  # [B, T, D]
    per_table = {}
    for g, pooled in zip(groups, pooled_list):
        for i, tid in enumerate(g.table_ids):
            per_table[tid] = pooled[i]  # [B, dim_g]
    slots = []
    for t in range(config.num_tables):
        y = per_table[t]
        if config.slots_per_table[t] == 1:
            slots.append(y)
        else:
            slots.extend(torch.split(y, d, dim=1))
    return torch.stack(slots, dim=1)  # [B, S, D]


def forward_from_pooled(
    params: Dict,
    config: DLRMConfig,
    groups: Sequence[TableGroup],
    dense_x: torch.Tensor,
    pooled_list: Sequence[torch.Tensor],
) -> torch.Tensor:
    """bottom MLP + interaction + top MLP from pooled embeddings -> logits.
    Differentiable with respect to the dense params and the pooled
    tensors; the stores are reached only through the sparse update."""
    cdt = DTYPES[config.compute_dtype]
    with phase_scope("bottom_mlp"):
        x = apply_mlp(dense_x, params["bot"], config.sigmoid_bot, cdt)
    ly = assemble_slots(pooled_list, groups, config)
    with phase_scope("interaction"):
        z = interact_features(
            x, ly, config.interaction, config.interact_itself, cdt,
            impl=config.interaction_impl,
        )
    # logits: the reference's top sigmoid is folded into loss / prediction
    with phase_scope("top_mlp"):
        return apply_mlp(
            z, params["top"], config.sigmoid_top, cdt, skip_last_activation=True
        )


def forward_logits(
    params: Dict,
    config: DLRMConfig,
    groups: Sequence[TableGroup],
    dense_x: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    pooled = lookup_all_groups(params, groups, indices, weights)
    return forward_from_pooled(params, config, groups, dense_x, pooled)


def forward(
    params: Dict,
    config: DLRMConfig,
    groups: Sequence[TableGroup],
    dense_x: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Click probability [B, 1] (sigmoid + loss_threshold clamp)."""
    z = forward_logits(params, config, groups, dense_x, indices, weights)
    return predictions_from_logits(z, config.loss_threshold)
