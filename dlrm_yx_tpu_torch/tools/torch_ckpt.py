"""Both-way converter between the reference's PyTorch checkpoints and the
port's checkpoint directories.

The port of ``dlrm_yx_tpu/tools/torch_ckpt.py``. The reference saves one
``torch.save`` dict (``dlrm_s_pytorch.py:1123-1129,2025-2038``): counters,
metrics, ``state_dict`` and ``opt_state_dict``, restored by its
``--load-model`` (``:1698-1755``).

- **import**: a reference ``.pt`` -> a checkpoint directory
  (``train/checkpoint.py``, the JAX package's npz layout) that
  ``--load-model`` takes: params, the optimizer's accumulators (Adagrad,
  RWSAdagrad) and the epoch / iteration / metric counters.
- **export**: a checkpoint directory (or params in memory) -> a ``.pt``
  whose ``state_dict`` the reference's ``DLRM_Net`` loads as it is.

State-dict keys (the reference's module registration order,
``dlrm_s_pytorch.py:469-480,495-496``):

    emb_l.{t}.weight                     regular EmbeddingBag [n, d]
    emb_l.{t}.weight_q / .weight_r       QREmbeddingBag (tricks/qr_embedding_bag.py:139-140)
    emb_l.{t}.embs.weight [, .proj.weight]  PrEmbeddingBag (tricks/md_embedding_bag.py:63-77)
    v_W_l.{t}                            learned per-sample weights [n]
    bot_l.{2j}.weight / .bias            torch Linear [out, in]: TRANSPOSED
    top_l.{2j}.weight / .bias            to / from the port's [in, out]

A table's rows sit in its group store at the group's row offset; the port's
stores are logical ``[total_rows, dim]`` rows, so no packing is involved.
The JAX package's tool takes a detour through JAX arrays; the port's
params are torch tensors already. ``main`` is host code and runs on the
CPU, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.models.dlrm import DTYPES, model_groups, qr_specs
from dlrm_yx_tpu_torch.optim.optimizer import OptConfig, acc_len, init_opt_state
from dlrm_yx_tpu_torch.utils.device import resolve_device


def _f32(x) -> torch.Tensor:
    """A state-dict value (tensor or array) as an f32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _emb_table_from_sd(sd: Dict, t: int) -> torch.Tensor:
    """One regular table's [n, d] rows, whichever module saved them. With
    --md-flag the reference wraps every table over md_threshold in
    PrEmbeddingBag, even when its solved dim is the base dim (proj =
    Identity, dlrm_s_pytorch.py:291-299): those are plain tables here."""
    for key in (f"emb_l.{t}.weight", f"emb_l.{t}.embs.weight"):
        if key in sd:
            return _f32(sd[key])
    raise KeyError(f"table {t}: neither emb_l.{t}.weight nor emb_l.{t}.embs.weight "
                   "in state_dict — arch flags do not match the checkpoint")


def _layer_indices(sd: Dict, prefix: str) -> List[int]:
    """Sorted nn.Sequential indices of the Linear layers under a prefix
    (Linears sit at even slots, between the activations)."""
    return sorted(int(k.split(".")[1]) for k in sd
                  if k.startswith(prefix + ".") and k.endswith(".weight"))


def _md_wrapped_ids(config: DLRMConfig) -> set:
    """Tables the reference wraps in PrEmbeddingBag (keys emb_l.{t}.embs.*):
    md_flag and rows > md_threshold, tables whose solved dim is the base
    dim included, unless QR took them first (dlrm_s_pytorch.py:282-299)."""
    if not config.md_flag:
        return set()
    qr = set(config.qr_table_ids)
    return {t for t, n in enumerate(config.emb_rows) if n > config.md_threshold and t not in qr}


def _mlp_from_sd(sd: Dict, prefix: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    return [(_f32(sd[f"{prefix}.{i}.weight"]).T.contiguous(), _f32(sd[f"{prefix}.{i}.bias"]))
            for i in _layer_indices(sd, prefix)]  # [out, in] -> [in, out]


def params_from_state_dict(sd: Dict, config: DLRMConfig,
                           device: Optional[Union[str, torch.device]] = None) -> Dict:
    """A reference ``state_dict`` -> the port's params (``init_dlrm``'s
    structure) on ``device``."""
    dev = resolve_device(device)
    groups = model_groups(config)
    emb = []
    for g in groups:
        store = torch.zeros((g.total_rows, g.dim), dtype=torch.float32)
        for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            tbl = _emb_table_from_sd(sd, tid)
            if tuple(tbl.shape) != (n, g.dim):
                raise ValueError(f"table {tid}: checkpoint shape {tuple(tbl.shape)} != "
                                 f"config shape {(n, g.dim)}")
            store[off:off + n] = tbl
        emb.append(store.to(DTYPES[config.emb_dtype]).to(dev))
    params: Dict = {
        "bot": [(w.to(dev), b.to(dev)) for w, b in _mlp_from_sd(sd, "bot_l")],
        "top": [(w.to(dev), b.to(dev)) for w, b in _mlp_from_sd(sd, "top_l")],
        "emb": emb,
        "vw": None,
    }
    exp_bot, exp_top = len(config.ln_bot) - 1, len(config.ln_top) - 1
    if len(params["bot"]) != exp_bot or len(params["top"]) != exp_top:
        raise ValueError(f"MLP depth mismatch: checkpoint bot/top {len(params['bot'])}/"
                         f"{len(params['top'])} vs config {exp_bot}/{exp_top}")
    if config.weighted_pooling is not None:
        vw = []
        for g in groups:
            v = torch.zeros(g.total_rows, dtype=torch.float32)
            for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
                key = f"v_W_l.{tid}"
                # learned weights are saved Parameters; fixed mode keeps plain
                # (unregistered) ones: re-init to ones
                v[off:off + n] = _f32(sd[key]) if key in sd else 1.0
            vw.append(v.to(dev))
        params["vw"] = vw
    specs = qr_specs(config)
    if specs:
        params["qr"] = [(_f32(sd[f"emb_l.{s.table_id}.weight_q"]).to(dev),
                         _f32(sd[f"emb_l.{s.table_id}.weight_r"]).to(dev)) for s in specs]
    if config.md_table_ids:
        params["md_proj"] = [_f32(sd[f"emb_l.{t}.proj.weight"]).T.contiguous().to(dev)
                             for t in config.md_table_ids]
    return params


def state_dict_from_params(params: Dict, config: DLRMConfig) -> Dict[str, np.ndarray]:
    """The port's params -> a reference ``state_dict`` (f32 numpy values;
    ``torch.tensor`` them at save time)."""
    groups = model_groups(config)
    sd: Dict[str, np.ndarray] = {}
    md_ids = _md_wrapped_ids(config)
    for g, store in zip(groups, params["emb"]):
        rows = _np(store)
        for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            key = f"emb_l.{tid}.embs.weight" if tid in md_ids else f"emb_l.{tid}.weight"
            sd[key] = rows[off:off + n]
    for s, (q, r) in zip(qr_specs(config), params.get("qr", [])):
        sd[f"emb_l.{s.table_id}.weight_q"] = _np(q)
        sd[f"emb_l.{s.table_id}.weight_r"] = _np(r)
    for t, w in zip(config.md_table_ids, params.get("md_proj", [])):
        sd[f"emb_l.{t}.proj.weight"] = _np(w).T.copy()
    if config.weighted_pooling == "learned" and params.get("vw") is not None:
        for g, v in zip(groups, params["vw"]):
            flat = _np(v)
            for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
                sd[f"v_W_l.{tid}"] = flat[off:off + n]
    for name, key in (("bot", "bot_l"), ("top", "top_l")):
        for j, (w, b) in enumerate(params[name]):
            sd[f"{key}.{2 * j}.weight"] = _np(w).T.copy()
            sd[f"{key}.{2 * j}.bias"] = _np(b)
    return sd


# --------------------------------------------------------------- optimizer


def _torch_param_order(sd: Dict, config: DLRMConfig) -> List[str]:
    """state_dict keys in the reference's ``dlrm.parameters()`` order
    (registration order: emb_l, v_W_l [learned], bot_l, top_l,
    dlrm_s_pytorch.py:469-480,495-496); torch's ``Optimizer.state_dict``
    numbers params in this order."""
    order: List[str] = []
    for t in range(len(config.emb_rows)):
        for suffix in ("weight", "weight_q", "weight_r", "embs.weight", "proj.weight"):
            key = f"emb_l.{t}.{suffix}"
            if key in sd:
                order.append(key)
    if config.weighted_pooling == "learned":
        order.extend(k for k in (f"v_W_l.{t}" for t in range(len(config.emb_rows))) if k in sd)
    for prefix in ("bot_l", "top_l"):
        for i in _layer_indices(sd, prefix):
            order.append(f"{prefix}.{i}.weight")
            order.append(f"{prefix}.{i}.bias")
    return order


def opt_state_from_torch(opt_sd: Optional[Dict], sd: Dict, config: DLRMConfig,
                         opt: OptConfig, params: Dict) -> Dict:
    """A torch optimizer ``state_dict`` -> the port's accumulators, on the
    params' device. Adagrad: per-element ``sum``; RWSAdagrad: per-row
    ``momentum`` for the tables and ``sum`` for the dense params
    (optim/rwsadagrad.py:74-86 there). No state, or SGD: fresh zeros."""
    groups = model_groups(config)
    state = init_opt_state(opt, params, groups)
    if not opt_sd or opt.name == "sgd":
        return state
    dev = params["emb"][0].device
    order = _torch_param_order(sd, config)
    ids: List[int] = []  # torch numbers params consecutively across param_groups
    for pg in opt_sd.get("param_groups", []):
        ids.extend(pg["params"])
    by_key: Dict[str, Dict] = {}
    for idx, key in zip(ids, order):
        if idx in opt_sd.get("state", {}):
            by_key[key] = opt_sd["state"][idx]
    if len(ids) != len(order):
        raise ValueError(f"optimizer state has {len(ids)} params but the arch expects "
                         f"{len(order)} — checkpoint/arch mismatch")
    # a rwsadagrad checkpoint keeps row 'momentum' (no 'sum') for the tables:
    # importing it as adagrad would restart every table denominator at zero
    if opt.name == "adagrad":
        mom_only = [k for k in by_key if k.startswith("emb_l.")
                    and "momentum" in by_key[k] and "sum" not in by_key[k]]
        if mom_only:
            raise ValueError(
                f"{len(mom_only)} embedding tables carry row-wise 'momentum' (a rwsadagrad "
                "checkpoint) but --optimizer adagrad was requested; import with --optimizer "
                "rwsadagrad (the row momenta cannot reconstruct per-element sums)")

    def acc_of(key: str, want_row_wise: bool) -> Optional[torch.Tensor]:
        st = by_key.get(key)
        if st is None:
            return None
        field = "momentum" if (want_row_wise and "momentum" in st) else "sum"
        return _f32(st[field]) if field in st else None

    row_wise = opt.name == "rwsadagrad"
    emb_acc = []
    for g in groups:
        acc = torch.zeros((acc_len(g.total_rows),) if row_wise else (g.total_rows, g.dim))
        for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            key = (f"emb_l.{tid}.embs.weight" if f"emb_l.{tid}.embs.weight" in sd
                   else f"emb_l.{tid}.weight")
            a = acc_of(key, row_wise)
            if a is None:
                continue
            if row_wise and a.dim() == 2:  # rwsadagrad saw only dense grads
                a = a.mean(dim=1)
            acc[off:off + n] = a
        emb_acc.append(acc.to(dev))
    state["emb"] = emb_acc
    for name, prefix in (("bot", "bot_l"), ("top", "top_l")):  # [out, in] -> [in, out]
        tower = []
        for j, (zw, zb) in enumerate(state["dense"][name]):
            aw = acc_of(f"{prefix}.{2 * j}.weight", False)
            ab = acc_of(f"{prefix}.{2 * j}.bias", False)
            tower.append((aw.T.contiguous().to(dev) if aw is not None else zw,
                          ab.to(dev) if ab is not None else zb))
        state["dense"][name] = tower
    if "qr" in state:
        qr_acc = []
        for s, (zq, zr) in zip(qr_specs(config), state["qr"]):
            pair = []
            for a, z in ((acc_of(f"emb_l.{s.table_id}.weight_q", row_wise), zq),
                         (acc_of(f"emb_l.{s.table_id}.weight_r", row_wise), zr)):
                if a is not None and row_wise and a.dim() == 2:
                    a = a.mean(dim=1)
                pair.append(a.to(dev) if a is not None else z)
            qr_acc.append(tuple(pair))
        state["qr"] = qr_acc
    if "md_proj" in state:
        state["md_proj"] = [
            a.T.contiguous().to(dev) if (a := acc_of(f"emb_l.{t}.proj.weight", False)) is not None
            else z for t, z in zip(config.md_table_ids, state["md_proj"])]
    if "vw" in state and config.weighted_pooling == "learned":
        vw_acc = []
        for g, z in zip(groups, state["vw"]):
            acc = torch.zeros(g.total_rows)
            hit = False
            for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
                a = acc_of(f"v_W_l.{tid}", False)
                if a is not None:
                    acc[off:off + n] = a
                    hit = True
            vw_acc.append(acc.to(dev) if hit else z)
        state["vw"] = vw_acc
    return state


def torch_opt_state_from_ours(opt_state: Dict, sd: Dict, config: DLRMConfig, opt: OptConfig,
                              step: int = 0) -> Dict:
    """The port's accumulators -> a torch ``Optimizer.state_dict`` that the
    reference's single-process run loads (one param group, as its
    single-device ``dlrm.parameters()`` gives, dlrm_s_pytorch.py:1645-1648).
    SGD and Adagrad groups come from real torch optimizers over
    shape-matched dummies (their hyperparameter keys whatever the torch
    version); RWSAdagrad's follow optim/rwsadagrad.py's defaults there."""
    order = _torch_param_order(sd, config)
    groups = model_groups(config)
    if opt.name in ("sgd", "adagrad"):
        dummies = [torch.zeros(tuple(np.asarray(sd[k]).shape), requires_grad=True)
                   for k in order]
        cls = torch.optim.SGD if opt.name == "sgd" else torch.optim.Adagrad
        osd = cls(dummies, lr=opt.lr).state_dict()
    else:  # rwsadagrad: the group keys of the reference's RWSAdagrad.__init__
        osd = {"state": {}, "param_groups": [{
            "lr": opt.lr, "lr_decay": 0.0, "weight_decay": 0.0, "eps": opt.eps,
            "params": list(range(len(order)))}]}
    if opt.name == "sgd":
        return osd  # plain SGD holds no per-param state
    row_wise = opt.name == "rwsadagrad"
    md_ids = _md_wrapped_ids(config)
    emb_key = {}
    for g, acc in zip(groups, opt_state["emb"]):
        acc_np = _np(acc)
        for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
            k = f"emb_l.{tid}.embs.weight" if tid in md_ids else f"emb_l.{tid}.weight"
            emb_key[k] = acc_np[off:off + n]
    for s, (aq, ar) in zip(qr_specs(config), opt_state.get("qr", [])):
        emb_key[f"emb_l.{s.table_id}.weight_q"] = _np(aq)
        emb_key[f"emb_l.{s.table_id}.weight_r"] = _np(ar)
    dense_key = {}
    for t, a in zip(config.md_table_ids, opt_state.get("md_proj", [])):
        dense_key[f"emb_l.{t}.proj.weight"] = _np(a).T.copy()
    if config.weighted_pooling == "learned" and opt_state.get("vw") is not None:
        for g, a in zip(groups, opt_state["vw"]):
            flat = _np(a)
            for tid, n, off in zip(g.table_ids, g.rows, g.row_offsets):
                dense_key[f"v_W_l.{tid}"] = flat[off:off + n]
    for name, prefix in (("bot", "bot_l"), ("top", "top_l")):
        for j, (aw, ab) in enumerate(opt_state["dense"][name]):
            dense_key[f"{prefix}.{2 * j}.weight"] = _np(aw).T.copy()
            dense_key[f"{prefix}.{2 * j}.bias"] = _np(ab)
    state = {}
    for idx, key in enumerate(order):
        if key in emb_key:
            field = "momentum" if row_wise else "sum"
            state[idx] = {"step": int(step), field: torch.tensor(emb_key[key])}
        elif key in dense_key:
            state[idx] = {"step": int(step), "sum": torch.tensor(dense_key[key])}
        elif idx in osd["state"]:  # keep the dummy optimizer's zeros
            state[idx] = osd["state"][idx]
    osd["state"] = state
    return osd


# --------------------------------------------------------------- top level


def import_torch_checkpoint(pt_path: str, config: DLRMConfig, out_dir: str,
                            opt: Optional[OptConfig] = None,
                            device: Optional[Union[str, torch.device]] = None) -> Dict:
    """A reference ``.pt`` -> a checkpoint directory that ``--load-model``
    takes. Returns the meta dict written."""
    from dlrm_yx_tpu_torch.train.checkpoint import save_checkpoint

    ld = torch.load(pt_path, map_location="cpu", weights_only=False)
    sd = ld["state_dict"] if "state_dict" in ld else ld
    params = params_from_state_dict(sd, config, device)
    opt = opt or OptConfig(name="sgd")
    opt_state = opt_state_from_torch(ld.get("opt_state_dict"), sd, config, opt, params)
    metrics = {}
    if "test_acc" in ld:
        metrics["accuracy"] = float(ld["test_acc"])
    if "test_auc" in ld:
        metrics["roc_auc"] = float(ld["test_auc"])
    meta = {"epoch": int(ld.get("epoch", 0)), "iteration": int(ld.get("iter", 0)),
            "metrics": metrics}
    save_checkpoint(out_dir, params, opt_state, config, epoch=meta["epoch"],
                    iteration=meta["iteration"], train_loss=float(ld.get("train_loss", 0.0)),
                    metrics=metrics, optimizer=opt.name)
    return meta


def export_torch_checkpoint(out_path: str, config: DLRMConfig, params: Dict, *,
                            opt_state: Optional[Dict] = None, opt: Optional[OptConfig] = None,
                            meta: Optional[Dict] = None, nbatches: int = 0,
                            nbatches_test: int = 0) -> None:
    """Params (and optimizer state) -> a ``.pt`` the reference's
    ``--load-model`` takes. Its loader reads ``opt_state_dict`` unless
    --inference-only (dlrm_s_pytorch.py:1729), so one is always written:
    the given accumulators, or a zero state. For the reference's
    single-process optimizer (one param group); its multi-rank mode builds
    3 groups."""
    meta = meta or {}
    np_sd = state_dict_from_params(params, config)
    sd = {k: torch.tensor(v) for k, v in np_sd.items()}
    opt = opt or OptConfig(name="sgd")
    if opt_state is None:
        opt_state = init_opt_state(opt, params, model_groups(config))
    osd = torch_opt_state_from_ours(opt_state, np_sd, config, opt,
                                    step=int(meta.get("iteration", 0)))
    metrics = meta.get("metrics", {})
    torch.save({
        "epoch": int(meta.get("epoch", 0)),
        "iter": int(meta.get("iteration", 0)),
        "nepochs": int(meta.get("nepochs", 1)),
        "nbatches": int(nbatches),
        "nbatches_test": int(nbatches_test),
        "state_dict": sd,
        "opt_state_dict": osd,
        "train_loss": float(meta.get("train_loss", 0.0)),
        "total_loss": float(meta.get("total_loss", 0.0)),
        "test_acc": float(metrics.get("accuracy", 0.0)),
        **({"test_auc": float(metrics["roc_auc"])} if metrics.get("roc_auc") is not None
           else {}),
    }, out_path)


def main(argv=None):
    """The converter's command line: host work on files, on the CPU."""
    from dlrm_yx_tpu_torch.cli import build_parser, config_from_args

    p = argparse.ArgumentParser(
        prog="python -m dlrm_yx_tpu_torch.tools.torch_ckpt",
        description="Convert checkpoints between the reference's torch .pt format and the "
                    "port's checkpoint directories. Arch flags (--arch-*, --qr-*, --md-*, "
                    "--max-ind-range, --weighted-pooling) must match the model the "
                    "checkpoint was trained with and pass through to the trainer's parser.",
        add_help=False,
    )
    p.add_argument("--import-pt", type=str, default="", metavar="FILE.pt",
                   help="reference .pt -> --ckpt-dir (loadable by --load-model)")
    p.add_argument("--export-pt", type=str, default="", metavar="FILE.pt",
                   help="--ckpt-dir -> reference-compatible .pt")
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="the port's checkpoint directory (required)")
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adagrad", "rwsadagrad"],
                   help="optimizer whose accumulators to convert")
    p.add_argument("--learning-rate", type=float, default=0.1)
    argv_list = list(argv) if argv is not None else None
    probe = argv_list if argv_list is not None else sys.argv[1:]
    if "-h" in probe or "--help" in probe:
        print(p.format_help())
        print("All trainer arch/model flags are also accepted "
              "(python -m dlrm_yx_tpu_torch.cli --help for the full list).")
        raise SystemExit(0)
    args, rest = p.parse_known_args(argv_list)
    if not args.ckpt_dir:
        raise SystemExit("--ckpt-dir is required")
    arch = build_parser().parse_args(rest + ["--data-generation", "random"])
    cfg = config_from_args(arch, argv_list)
    if arch.max_ind_range > 0:
        # the reference caps table rows at --max-ind-range (dlrm_s_pytorch.py:
        # 1390-1398); the published Terabyte checkpoints were trained so
        cfg = dataclasses.replace(
            cfg, emb_rows=tuple(min(n, arch.max_ind_range) for n in cfg.emb_rows))
    if bool(args.import_pt) == bool(args.export_pt):
        raise SystemExit("pass exactly one of --import-pt / --export-pt")
    opt = OptConfig(name=args.optimizer, lr=args.learning_rate)
    if args.import_pt:
        meta = import_torch_checkpoint(args.import_pt, cfg, args.ckpt_dir, opt, device="cpu")
        print(f"imported {args.import_pt} -> {args.ckpt_dir} (meta {meta})")
        return
    from dlrm_yx_tpu_torch.models.dlrm import init_dlrm
    from dlrm_yx_tpu_torch.train.checkpoint import load_checkpoint

    like_p = init_dlrm(cfg, seed=0, device="cpu")
    like_s = init_opt_state(opt, like_p, model_groups(cfg))
    params, opt_state, meta = load_checkpoint(args.ckpt_dir, like_p, like_s)
    ck_opt = meta.get("optimizer")
    if ck_opt is not None and ck_opt != opt.name:
        raise SystemExit(f"checkpoint {args.ckpt_dir!r} carries {ck_opt} state; "
                         f"pass --optimizer {ck_opt}")
    export_torch_checkpoint(args.export_pt, cfg, params, opt_state=opt_state, opt=opt, meta=meta)
    print(f"exported {args.ckpt_dir} -> {args.export_pt}")


if __name__ == "__main__":
    main()
