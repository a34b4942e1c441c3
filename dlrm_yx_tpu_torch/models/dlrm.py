"""The DLRM model: bottom MLP + embedding lookups + interaction + top MLP.

The port of ``dlrm_yx_tpu/models/dlrm.py``. The functions keep the JAX
package's shape: parameters are a dict

    {"bot": [(W [in, out], b), ...], "top": [(W, b), ...],
     "emb": [store [total_rows, dim] per group, ...],
     "vw": [pooling weights [total_rows] per group, ...] or None,
     "qr": [(Q [q_rows, dim], R [collisions, dim]) per QR table]  (QR only),
     "md_proj": [W [dim_t, base_dim] per MD table]                (MD only),
     "dcn": [(V [N, r], W [r, N], b [N]) per cross layer]        (dcn only)}

whose dense leaves (``DENSE_KEYS``: towers, MD projections, cross layers)
every step and optimizer takes in one order (``dense_leaves`` /
``nest_dense``), and the forward is split at the pooled-embedding boundary
(``forward_from_pooled``) as it is there. ``DLRM`` is the ``nn.Module``
that owns such a dict as registered parameters (so ``state_dict``,
``parameters`` and ``to`` work) and runs ``forward_logits``.

The embedding variants, as in the JAX package: QR tables (rows >
``qr_threshold`` with ``qr_flag``) leave the groups for their own
quotient and remainder stores (``ops/qr_embedding.py``); a mixed-dimension
table (``md_table_ids``) sits in the group of its own dim and its pooled
vector is up-projected to the base dim by ``md_proj``; weighted pooling
weighs each looked-up row by ``vw`` (ones at init). The JAX package
refuses learned pooling with QR tables, and QR or MD tables in
``init_dlrm_on_device``; the port refuses them too.

DLRM-DCNv2 (the port's own): the ``dcn`` interaction sends the
concatenated features through the cross network (``ops/dcn.py``, the span
``dcn``), and fixed multi-hot bags (``config.multi_hot_sizes``) are
looked up in the bag layout (``ops/embedding.lookup_bags``, the span
``lookup.bags``). Each lookup counts its items: ``lookup.items`` (every
item of the L=1 and bag layouts, all live) and ``lookup.pad_items`` (0
there). The padded ``[T, B, L]`` layout gathers T * B * L slots, whose
live ones its weights on the device mark; without a sync it counts one a
bag as live and the other T * B * (L - 1) as padding, so the live share
it gives is a floor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.ops.dcn import cross_net, init_dcn
from dlrm_yx_tpu_torch.ops.embedding import (
    TableGroup,
    bag_slots,
    build_table_groups,
    device_ints,
    lookup_bags,
    lookup_group,
)
from dlrm_yx_tpu_torch.ops.interaction import interact_features
from dlrm_yx_tpu_torch.ops.losses import predictions_from_logits
from dlrm_yx_tpu_torch.ops.md_embedding import init_md_projection
from dlrm_yx_tpu_torch.ops.mlp import apply_mlp, init_mlp
from dlrm_yx_tpu_torch.ops.qr_embedding import QRSpec, init_qr, qr_lookup
from dlrm_yx_tpu_torch.utils.device import resolve_device
from dlrm_yx_tpu_torch.utils.profiling import count, phase_scope

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


def qr_specs(config: DLRMConfig) -> List[QRSpec]:
    return [
        QRSpec(
            table_id=t,
            rows=config.emb_rows[t],
            dim=config.emb_dims[t],
            collisions=config.qr_collisions,
            operation=config.qr_operation,
        )
        for t in config.qr_table_ids
    ]


# the dense params, trained by autograd and the dense optimizer, in their
# one order: the towers, the MD projections, the cross layers, and HSTU's
# position embedding and blocks (models/hstu.py)
DENSE_KEYS = ("bot", "top", "md_proj", "dcn", "hstu_pos", "hstu_blocks")


def dense_leaves(tree: Dict) -> List[torch.Tensor]:
    """The dense leaves of a params (or grads) tree, in ``DENSE_KEYS``
    order, each entry's tensors in order: (W, b) a tower layer, W an MD
    projection, (V, W, b) a cross layer, HSTU's position table, (W_uvqk,
    W_o, b_o, pos_w, time_w) an HSTU block; the keys the tree lacks are
    skipped."""
    return [t for k in DENSE_KEYS if k in tree
            for entry in tree[k] for t in (entry if isinstance(entry, (tuple, list)) else (entry,))]


def nest_dense(like: Dict, leaves: Sequence[torch.Tensor]) -> Dict:
    """``dense_leaves``' inverse: {key: entries} of ``like``'s dense keys,
    holding ``leaves`` in its nesting (an entry of several tensors a
    tuple)."""
    it = iter(leaves)
    return {k: [tuple(next(it) for _ in entry) if isinstance(entry, (tuple, list)) else next(it)
                for entry in like[k]]
            for k in DENSE_KEYS if k in like}


def _ones_vw(groups: Sequence[TableGroup], config: DLRMConfig, device: torch.device):
    """v_W = ones(n) per table, zero on padding rows, flat per group
    (dlrm_s_pytorch.py:313-316); None without weighted pooling."""
    if config.weighted_pooling is None:
        return None
    vw = []
    for g in groups:
        v = torch.zeros(g.total_rows, dtype=torch.float32, device=device)
        for n, off in zip(g.rows, g.row_offsets):
            v[off : off + n] = 1.0
        vw.append(v)
    return vw


def _dense_params(rng: np.random.RandomState, config: DLRMConfig,
                  device: torch.device) -> Dict:
    def to_dev(layers):
        return [(torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
                for w, b in layers]

    bot = to_dev(init_mlp(rng, config.ln_bot))
    out = {"bot": bot, "top": to_dev(init_mlp(rng, config.ln_top))}
    if config.interaction == "dcn":
        # drawn after the towers, so the other leaves keep their draws
        out["dcn"] = [tuple(torch.from_numpy(a).to(device) for a in layer)
                      for layer in init_dcn(rng, config.ln_top[0], config.dcn_low_rank_dim,
                                            config.dcn_num_layers)]
    return out


def init_dlrm(config: DLRMConfig, seed: int = 123,
              device: Optional[Union[str, torch.device]] = None) -> Dict:
    """All parameters from one numpy RandomState, in the JAX package's draw
    order: embedding tables in canonical table order (U(-1/sqrt n, 1/sqrt n),
    padding rows zero; a QR table draws its quotient then its remainder
    table), then the MD projections in table order, then the bottom MLP,
    then the top MLP. The values equal ``dlrm_yx_tpu.models.dlrm.init_dlrm``'s
    for the same seed. Each table is drawn straight into its group store's
    row block, so the host holds the stores once."""
    if config.weighted_pooling == "learned" and config.qr_table_ids:
        raise NotImplementedError("learned weighted pooling with QR tables")
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    groups = model_groups(config)
    specs = {s.table_id: s for s in qr_specs(config)}
    stores = [np.zeros((g.total_rows, g.dim), dtype=np.float32) for g in groups]
    where = {
        t: (gi, off)
        for gi, g in enumerate(groups)
        for t, off in zip(g.table_ids, g.row_offsets)
    }
    qr = {}
    for t, (n, d) in enumerate(zip(config.emb_rows, config.emb_dims)):
        if t in specs:
            qr[t] = tuple(torch.from_numpy(a).to(dev) for a in init_qr(rng, specs[t]))
            continue
        gi, off = where[t]
        bound = np.sqrt(1.0 / n)
        for r0 in range(0, n, _INIT_CHUNK_ROWS):
            r1 = min(n, r0 + _INIT_CHUNK_ROWS)
            stores[gi][off + r0 : off + r1] = rng.uniform(
                -bound, bound, size=(r1 - r0, d)
            ).astype(np.float32)
    md_proj = [
        torch.from_numpy(init_md_projection(rng, config.emb_dims[t], config.base_dim)).to(dev)
        for t in config.md_table_ids
    ]
    edt = DTYPES[config.emb_dtype]
    emb = [torch.from_numpy(s).to(dev).to(edt) for s in stores]
    del stores
    params = {**_dense_params(rng, config, dev), "emb": emb,
              "vw": _ones_vw(groups, config, dev)}
    if specs:
        params["qr"] = [qr[t] for t in config.qr_table_ids]
    if md_proj:
        params["md_proj"] = md_proj
    return params


def init_dlrm_on_device(config: DLRMConfig, seed: int = 123,
                        device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Large-model initializer: embedding stores are drawn on the device
    with a ``torch.Generator`` (seeded ``seed + group index``), so the
    tables never exist on the host. Same distribution as ``init_dlrm``
    (U(-1/sqrt n, 1/sqrt n) per table, zero padding rows), other values.
    Each table is drawn in f32 blocks of ``_DEVICE_CHUNK_ROWS`` rows cast
    into the store, so the device holds the store and one block (a bf16
    store of 13.8 GB never has an f32 twin). The dense params take the
    numpy draws that the JAX package's ``init_dlrm_on_device`` takes;
    weighted pooling's ``vw`` starts at ones. Plain tables only: QR and MD
    tables raise, as in the JAX package."""
    if config.qr_table_ids or config.md_table_ids:
        raise NotImplementedError("device init supports plain tables only")
    dev = resolve_device(device)
    edt = DTYPES[config.emb_dtype]
    groups = model_groups(config)
    emb = []
    for gi, g in enumerate(groups):
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
    return {**_dense_params(np.random.RandomState(seed), config, dev), "emb": emb,
            "vw": _ones_vw(groups, config, dev)}


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
        # the stores (and QR sub-tables, pooling weights) are updated
        # row-sparsely by hand, never by autograd
        def sparse(ts):
            return nn.ParameterList([nn.Parameter(t, requires_grad=False) for t in ts])

        self.emb = sparse(params["emb"])
        self.vw = None if params.get("vw") is None else sparse(params["vw"])
        self.qr_q = sparse([q for q, _ in params.get("qr", ())])
        self.qr_r = sparse([r for _, r in params.get("qr", ())])
        self.md_proj = nn.ParameterList(params.get("md_proj", ()))
        dcn = params.get("dcn", ())
        self.dcn_v = nn.ParameterList([v for v, _, _ in dcn])
        self.dcn_w = nn.ParameterList([w for _, w, _ in dcn])
        self.dcn_b = nn.ParameterList([b for _, _, b in dcn])

    def as_params(self) -> Dict:
        params = {
            "bot": list(zip(self.bot_w, self.bot_b)),
            "top": list(zip(self.top_w, self.top_b)),
            "emb": list(self.emb),
            "vw": None if self.vw is None else list(self.vw),
        }
        if len(self.qr_q):
            params["qr"] = list(zip(self.qr_q, self.qr_r))
        if len(self.md_proj):
            params["md_proj"] = list(self.md_proj)
        if len(self.dcn_v):
            params["dcn"] = list(zip(self.dcn_v, self.dcn_w, self.dcn_b))
        return params

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
    hotness: Sequence[int] = (),
):
    """Pooled lookups for every group: [pooled_g [T_g, B, dim_g]]. With
    ``want_rows`` also the gathered rows per group ([T_g, B, dim_g] f32
    for an L=1 group, [S_g, B, dim_g] for a bag batch, else None), which
    the write-only sparse update reuses. Weighted pooling weighs each row
    by the group's ``vw``. ``hotness``: the fixed bag sizes of a bag batch
    ([S, B, 1] ids; ``config.multi_hot_sizes``), or () for [T, B, L]."""
    vw = params.get("vw")
    pooled, rows = [], []
    bags = bag_slots(groups, hotness)
    t_all, b, l = indices.shape
    # the padded layout's live items are in its weights on the device: it
    # counts a bag's first slot as live and its other l - 1 as padding
    count("lookup.items", t_all * b)
    count("lookup.pad_items", 0 if bags is not None else t_all * b * (l - 1))
    with phase_scope("embedding_lookup"):
        if bags is not None:
            with phase_scope("lookup.bags"):
                for gi, g in enumerate(groups):
                    res = lookup_bags(params["emb"][gi], g, bags[gi], indices,
                                      return_rows=want_rows)
                    pooled.append(res[0] if want_rows else res)
                    rows.append(res[1] if want_rows else None)
            return (pooled, rows) if want_rows else pooled
        for gi, g in enumerate(groups):
            idx_g = group_indices(g, indices)
            rows_ok = want_rows and idx_g.shape[2] == 1
            res = lookup_group(params["emb"][gi], g, idx_g, group_indices(g, weights),
                               None if vw is None else vw[gi], return_rows=rows_ok)
            pooled.append(res[0] if rows_ok else res)
            rows.append(res[1] if rows_ok else None)
    return (pooled, rows) if want_rows else pooled


def qr_lookup_all(params: Dict, config: DLRMConfig, indices: torch.Tensor,
                  weights: torch.Tensor) -> List[torch.Tensor]:
    """Pooled lookups of the QR tables: [pooled [B, out_dim]] in
    ``qr_table_ids`` order."""
    out = []
    with phase_scope("embedding_lookup"):
        for (q, r), spec in zip(params["qr"], qr_specs(config)):
            out.append(qr_lookup(q, r, spec, indices[spec.table_id], weights[spec.table_id]))
    return out


def assemble_slots(
    pooled_list: Sequence[torch.Tensor],
    groups: Sequence[TableGroup],
    config: DLRMConfig,
    qr_pooled: Sequence[torch.Tensor] = (),
    md_proj: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Reassemble group and QR pooled outputs into [B, S, D] canonical slot
    order, applying the split trick (dim k*D -> k slots of D;
    dlrm_s_pytorch.py:579-585; a QR concat table gives 2 slots) and the MD
    up-projections (``pooled @ md_proj``, an f32 product: TF32 is off on
    the card). When every table is one slot of dim D in a group (the
    Criteo configs) it is one concat and one row gather (none for a single
    group), returned as a transposed view that the fused interaction reads
    without a copy; the backward is then one scatter, not one per table.
    A QR table without its pooled vector raises ``KeyError``, as in the
    JAX package."""
    d = config.base_dim
    if (not config.qr_table_ids and all(g.dim == d for g in groups)
            and all(k == 1 for k in config.slots_per_table)):
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
    for tid, pooled in zip(config.qr_table_ids, qr_pooled):
        per_table[tid] = pooled
    md_ids = {tid: i for i, tid in enumerate(config.md_table_ids)}
    slots = []
    for t in range(config.num_tables):
        y = per_table[t]
        if t in md_ids:
            slots.append(y @ md_proj[md_ids[t]])  # up-projected to the base dim
        elif config.slots_per_table[t] == 1:
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
    qr_pooled: Sequence[torch.Tensor] = (),
) -> torch.Tensor:
    """bottom MLP + interaction + top MLP from pooled embeddings (groups'
    and QR tables') -> logits. Differentiable with respect to the dense
    params (the MD projections and the cross layers among them) and the
    pooled tensors; the stores are reached only through the sparse
    update."""
    cdt = DTYPES[config.compute_dtype]
    with phase_scope("bottom_mlp"):
        x = apply_mlp(dense_x, params["bot"], config.sigmoid_bot, cdt)
    ly = assemble_slots(pooled_list, groups, config, qr_pooled, params.get("md_proj"))
    if config.interaction == "dcn":
        with phase_scope("dcn"):
            z = cross_net(interact_features(x, ly, "cat"), params["dcn"], cdt)
    else:
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
    pooled = lookup_all_groups(params, groups, indices, weights,
                               hotness=config.multi_hot_sizes)
    qr_pooled = qr_lookup_all(params, config, indices, weights) if config.qr_table_ids else ()
    return forward_from_pooled(params, config, groups, dense_x, pooled, qr_pooled)


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
