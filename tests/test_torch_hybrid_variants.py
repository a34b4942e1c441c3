"""The embedding variants inside the port's hybrid step, in a gloo world of
4 CPU ranks (mesh 2 x 2), against the JAX package's ``HybridRunner`` on the
same mesh, each case one of ``tests/test_parallel.py:264-770``'s (its model,
batches of 8 with L=2, its sharder; from a nonzero optimizer state, as
``torch_hybrid_cases`` starts): QR 'mult' / 'add' (the replicated remainder
store) and 'concat' (pseudo-tables), mixed-dimension tables (the
up-projection after the exchange; RWSAdagrad's true-dim momentum), k*D
mixes, fixed and learned pooling weights, QR with fixed pooling, and all of
them under gradient accumulation. Losses, tables, eval predictions and the
variants' own leaves (``qr_r``, ``md_proj``, ``vw``) at rtol 1e-5 / atol
1e-6."""

import numpy as np
import pytest

from dlrm_yx_tpu.ops.md_embedding import md_solver
from torch_hybrid_cases import check_world_case, world_runner


def _f(slots, d=4):
    """ln_top for S slots of dim d: the dot interaction's size first."""
    f = slots + 1
    return (f * (f - 1) // 2 + d, 8, 1)


QR = dict(emb_rows=(500, 300, 40, 700), ln_bot=(4, 8, 4), qr_flag=True, qr_threshold=200,
          qr_collisions=4)
_MD_ROWS = (800, 50, 600, 40)
MODELS = {
    "qr_mult": dict(QR, ln_top=_f(4), qr_operation="mult"),
    "qr_add": dict(QR, ln_top=_f(4), qr_operation="add"),
    "qr_concat": dict(QR, ln_top=_f(7), qr_operation="concat"),
    "qr_fixed": dict(QR, ln_top=_f(4), qr_operation="mult", weighted_pooling="fixed"),
    "md": dict(emb_rows=_MD_ROWS, ln_bot=(4, 8, 8), ln_top=_f(4, 8), md_flag=True,
               md_threshold=200, emb_dims=tuple(
                   int(x) for x in md_solver(np.array(_MD_ROWS), 0.3, d0=8, round_dim=True))),
    "kd": dict(emb_rows=(30, 20, 10, 40), emb_dims=(8, 4, 8, 4), ln_bot=(4, 8, 4),
               ln_top=_f(6)),
    "fixed": dict(emb_rows=(60, 40, 90), ln_bot=(4, 8, 4), ln_top=_f(3),
                  weighted_pooling="fixed"),
    "learned": dict(emb_rows=(60, 40, 90), ln_bot=(4, 8, 4), ln_top=_f(3),
                    weighted_pooling="learned"),
}


def _case(name, model, opt, sharder="greedy", kind="train", steps=3, **kw):
    return dict(name=name, config=MODELS[model], opt=opt, lr=0.1, impl="xla", lookups=2,
                batch=8, steps=steps, kind=kind, sharder=sharder, **kw)


def _accum(name, model, opt):
    return _case(name, model, opt, sharder="naive", kind="accum", steps=2, n_accum=2)


CASES = {c["name"]: c for c in (
    _case("qr_mult_sgd", "qr_mult", "sgd"),
    _case("qr_add_rwsadagrad", "qr_add", "rwsadagrad"),
    _case("qr_mult_adagrad", "qr_mult", "adagrad"),
    _case("qr_concat_sgd", "qr_concat", "sgd"),
    _case("qr_concat_rwsadagrad", "qr_concat", "rwsadagrad"),
    _case("md_sgd", "md", "sgd"),
    _case("md_rwsadagrad", "md", "rwsadagrad"),
    _case("kd_sgd", "kd", "sgd"),
    _case("kd_rwsadagrad", "kd", "rwsadagrad"),
    _case("fixed_sgd", "fixed", "sgd"),
    _case("learned_sgd", "learned", "sgd"),
    _case("learned_rwsadagrad", "learned", "rwsadagrad"),
    _case("fixed_adagrad", "fixed", "adagrad"),
    _case("qr_fixed_rwsadagrad", "qr_fixed", "rwsadagrad", sharder="naive"),
    _accum("accum_fixed_sgd", "fixed", "sgd"),
    _accum("accum_learned_sgd", "learned", "sgd"),
    _accum("accum_learned_rwsadagrad", "learned", "rwsadagrad"),
    _accum("accum_qr_mult_sgd", "qr_mult", "sgd"),
    _accum("accum_qr_add_rwsadagrad", "qr_add", "rwsadagrad"),
    _accum("accum_qr_mult_adagrad", "qr_mult", "adagrad"),
    _accum("accum_qr_concat_sgd", "qr_concat", "sgd"),
    _accum("accum_md_rwsadagrad", "md", "rwsadagrad"),
)}
MESH = (2, 2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return world_runner(tmp_path_factory, CASES, {MESH: list(CASES)})


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_variant_matches_jax(monkeypatch, worlds, name):
    check_world_case(monkeypatch, worlds(MESH), MESH, name, CASES)
