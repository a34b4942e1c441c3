"""Module-level parity of the port (dlrm_yx_tpu_torch) with the JAX package:
config, batch helpers, embedding groups and lookup, MLP, losses, metrics,
the probability forward and the logging helpers. Small shapes, CPU only;
inputs from numpy seeds go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.batch import csr_to_padded as jax_csr_to_padded
from dlrm_yx_tpu.models.dlrm import forward as jax_forward
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.ops import embedding as jemb
from dlrm_yx_tpu.ops.interaction import tril_flat_indices as jax_tril_flat_indices
from dlrm_yx_tpu.ops.losses import loss_fn as jax_loss_fn
from dlrm_yx_tpu.ops.losses import predictions_from_logits as jax_predictions
from dlrm_yx_tpu.ops.mlp import apply_mlp as jax_apply_mlp
from dlrm_yx_tpu.ops.mlp import init_mlp as jax_init_mlp
from dlrm_yx_tpu.train import metrics as jax_metrics
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import params_from_jax
from dlrm_yx_tpu_torch.data.batch import csr_to_padded
from dlrm_yx_tpu_torch.models.dlrm import forward, model_groups
from dlrm_yx_tpu_torch.ops import embedding as pemb
from dlrm_yx_tpu_torch.ops.interaction import tril_flat_indices
from dlrm_yx_tpu_torch.ops.losses import loss_fn, predictions_from_logits
from dlrm_yx_tpu_torch.ops.mlp import apply_mlp, init_mlp
from dlrm_yx_tpu_torch.train import metrics
from dlrm_yx_tpu_torch.utils.logging import EventLogger
from dlrm_yx_tpu_torch.utils.profiling import phase_scope


def test_terabyte_config_matches_jax():
    p = DLRMConfig.terabyte_mlperf(max_ind_range=1_000_000)
    j = JaxConfig.terabyte_mlperf(max_ind_range=1_000_000)
    assert p.emb_rows == j.emb_rows and p.ln_top == j.ln_top
    assert p.ln_top[0] == p.base_dim + p.num_interactions == 479
    groups = model_groups(p)
    assert [g.num_tables for g in groups] == [18, 8]
    assert [g.rows for g in groups] == [g.rows for g in jax_model_groups(j)]


@pytest.mark.parametrize(
    "rows,dims,threshold",
    [((100, 200, 1000, 37), (128,) * 4, 150),
     ((4, 3, 70, 9), (16, 16, 32, 64), None),
     ((5, 6), (2, 2), 5)],
)
def test_table_groups_match_jax(rows, dims, threshold):
    assert pemb.build_table_groups(rows, dims, small_threshold=threshold) == [
        pemb.TableGroup(**vars(g))
        for g in jemb.build_table_groups(rows, dims, small_threshold=threshold)
    ]


@pytest.mark.parametrize("dim,l", [(128, 1), (16, 3), (32, 1)])
def test_lookup_group_matches_jax(dim, l):
    g = pemb.build_table_groups((50, 7, 300), (dim,) * 3)[0]
    rng = np.random.RandomState(dim + l)
    store = rng.randn(g.total_rows, dim).astype(np.float32)
    idx = np.stack([rng.randint(0, n, (16, l)) for n in g.rows]).astype(np.int32)
    w = (rng.rand(3, 16, l) > 0.3).astype(np.float32)
    want = jemb.lookup_group(jnp.asarray(jemb.pack_store(store, g)), g,
                             jnp.asarray(idx), jnp.asarray(w))
    got = pemb.lookup_group(torch.from_numpy(store), g, torch.from_numpy(idx),
                            torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    flat = pemb.global_row_ids(g, torch.from_numpy(idx)).reshape(-1)
    np.testing.assert_array_equal(
        pemb.gather_rows(torch.from_numpy(store), flat).numpy(), store[flat.numpy()])


def test_pack_store_is_the_jax_layout():
    g = pemb.build_table_groups((40, 9), (16, 16))[0]
    store = np.arange(g.total_rows * 16, dtype=np.float32).reshape(g.total_rows, 16)
    packed = pemb.pack_store(store, g)
    assert packed.shape == (g.total_rows // 8, 128)
    np.testing.assert_array_equal(packed, jemb.pack_store(store, jemb.build_table_groups((40, 9), (16, 16))[0]))
    np.testing.assert_array_equal(pemb.unpack_store(torch.from_numpy(packed), g).numpy(), store)


@pytest.mark.parametrize("offset", [-1, 0])
def test_tril_flat_indices_match_jax(offset):
    np.testing.assert_array_equal(tril_flat_indices(9, offset),
                                  jax_tril_flat_indices(9, offset))
    li, lj = torch.tril_indices(9, 9, offset)
    np.testing.assert_array_equal(tril_flat_indices(9, offset), (li * 9 + lj).numpy())


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigmoid_layer,skip_last", [(-1, False), (1, False), (2, True)])
def test_apply_mlp_matches_jax(cdt, sigmoid_layer, skip_last):
    ln = (13, 64, 32, 1)
    layers = jax_init_mlp(np.random.RandomState(4), ln)
    for (jw, jb), (pw, pb) in zip(layers, init_mlp(np.random.RandomState(4), ln)):
        np.testing.assert_array_equal(pw, jw)
        np.testing.assert_array_equal(pb, jb)
    x = np.random.RandomState(5).rand(64, 13).astype(np.float32)
    want = jax_apply_mlp(jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b)) for w, b in layers],
                         sigmoid_layer, jnp.dtype(cdt), skip_last)
    got = apply_mlp(torch.from_numpy(x),
                    [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers],
                    sigmoid_layer, getattr(torch, cdt), skip_last)
    assert got.dtype == torch.float32  # bf16 operands, f32 product (not bf16)
    tol = 1e-5 if cdt == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "loss,thr",
    [("bce", 0.0), ("bce", 1e-3), ("mse", 0.0), ("mse", 0.1), ("wbce", 0.0), ("wbce", 1e-2)],
)
def test_losses_match_jax(loss, thr):
    rng = np.random.RandomState(6)
    z = (4 * rng.randn(256, 1)).astype(np.float32)
    t = np.round(rng.rand(256, 1)).astype(np.float32)
    want = jax_loss_fn(jnp.asarray(z), jnp.asarray(t), loss, thr, (0.3, 2.0))
    got = loss_fn(torch.from_numpy(z), torch.from_numpy(t), loss, thr, (0.3, 2.0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(predictions_from_logits(torch.from_numpy(z), thr).numpy(),
                               np.asarray(jax_predictions(jnp.asarray(z), thr)),
                               rtol=1e-6, atol=1e-7)


def test_metrics_match_jax():
    rng = np.random.RandomState(8)
    s = np.round(rng.rand(3000), 3)  # ties on purpose
    t = (rng.rand(3000) < 0.3 + 0.4 * s).astype(np.float32)
    assert metrics.binary_metrics(s, t) == jax_metrics.binary_metrics(s, t)
    a, b = metrics.StreamingAUC(), jax_metrics.StreamingAUC()
    for part in np.array_split(np.arange(3000), 3):
        a.add(s[part], t[part])
        b.add(s[part], t[part])
    assert a.auc() == b.auc()
    assert abs(a.auc() - metrics.roc_auc_exact(s, t)) < 1e-3


def test_csr_to_padded_matches_jax():
    ls_i = [np.array([3, 1, 4, 1, 5]), np.array([9, 2])]
    ls_o = [np.array([0, 2, 2]), np.array([0, 1, 1])]
    for got, want in zip(csr_to_padded(ls_i, ls_o, 3, 3),
                         jax_csr_to_padded(ls_i, ls_o, 3, 3)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds"):
        csr_to_padded(ls_i, ls_o, 3, 2)


def test_forward_probabilities_match_jax():
    kw = dict(emb_rows=(20, 30), ln_bot=(4, 8), ln_top=(4, 1), loss_threshold=0.01)
    jcfg, pcfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    jp = jax_init_dlrm(jcfg, seed=2)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    rng = np.random.RandomState(3)
    dense = rng.rand(16, 4).astype(np.float32)
    idx = np.stack([rng.randint(0, n, (16, 2)) for n in (20, 30)]).astype(np.int32)
    w = np.ones((2, 16, 2), np.float32)
    want = jax_forward(jp, jcfg, jax_model_groups(jcfg), jnp.asarray(dense),
                       jnp.asarray(idx), jnp.asarray(w))
    got = forward(pp, pcfg, model_groups(pcfg), *map(torch.from_numpy, (dense, idx, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_event_logger_prints_mllog_lines(capsys):
    ev = EventLogger()
    ev.log_start("eval_start")
    ev.log_event("eval_accuracy", 0.5)
    ev.log_end("eval_stop")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" ", 1)[0] for ln in lines] == [":::MLLOG"] * 3
    assert '"key": "eval_accuracy", "value": 0.5' in lines[1]


def test_phase_scope_names_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phase_scope("interaction"):
            torch.ones(4).sum()
    assert "interaction" in {e.key for e in prof.key_averages()}
