"""The port's quantized serving (dlrm_yx_tpu_torch.ops.quantized) against
the JAX package's (dlrm_yx_tpu.ops.quantized) on the CPU.

Stores and MLP weights come from numpy seeds. Quantized stores, scales,
biases and tower weights are compared bit for bit, and so are the int8
product's int32 accumulators. Dequantized rows are held within one f32 ulp
(``vals * scale + bias`` may be contracted into one FMA by XLA and not by
torch). Pooled sums over L > 1 and everything after a tower's first layer
differ by summation order (and by an activation scale or a ReLU that a
last-bit difference can move): rtol 1e-5 / atol 1e-6, stated where used.
The eval steps of both packages are fed one quantized state through
``convert.qstores_from_jax`` / ``qmlp_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_yx_tpu.config import DLRMConfig as JaxConfig
from dlrm_yx_tpu.data.batch import Batch as JaxBatch
from dlrm_yx_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from dlrm_yx_tpu.models.dlrm import model_groups as jax_model_groups
from dlrm_yx_tpu.ops import quantized as jq
from dlrm_yx_tpu_torch.config import DLRMConfig
from dlrm_yx_tpu_torch.convert import params_from_jax, qmlp_from_jax, qstores_from_jax
from dlrm_yx_tpu_torch.data.batch import Batch
from dlrm_yx_tpu_torch.models.dlrm import model_groups
from dlrm_yx_tpu_torch.ops import quantized as pq

TOL = dict(rtol=1e-5, atol=1e-6)
# two groups at dim 16: the JAX package packs both 8 logical rows to a
# 128-lane row; the port keeps [total_rows, 16]
TWO_GROUPS = dict(emb_rows=(100, 200, 3000), ln_bot=(13, 32, 16), ln_top=(32, 8, 1),
                  emb_split_threshold=150, loss="bce")
# the JAX tests' fully quantized model (tests/test_variants.py:287)
TOWERS = dict(emb_rows=(300, 200, 100), ln_bot=(13, 64, 8), ln_top=(4 * 3 // 2 + 8, 64, 1),
              loss="bce")


def _store(rng, r, dim):
    s = rng.randn(r, dim).astype(np.float32)
    s[3] = 0.25  # a constant row: its scale is the 1e-12 floor
    return s


def _assert_qstore_equal(port_qs, jax_qs):
    assert port_qs.bits == jax_qs.bits and port_qs.dim == jax_qs.dim
    for name in ("data", "scale", "bias"):
        got = getattr(port_qs, name).numpy()
        want = np.asarray(getattr(jax_qs, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _within_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


def _batch(rows, b, l, seed, m_den=13):
    r = np.random.RandomState(seed)
    idx = np.stack([r.randint(0, n, (b, l)) for n in rows]).astype(np.int32)
    w = (r.rand(len(rows), b, l) * 2).astype(np.float32)
    w[:, : b // 4, l - 1] = 0.0  # padded lookups
    return (r.rand(b, m_den).astype(np.float32), idx, w,
            (r.rand(b, 1) > 0.5).astype(np.float32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(64, 16), (37, 128), (9, 6)])
def test_quantize_store_matches_jax_bit_for_bit(bits, shape):
    store = _store(np.random.RandomState(shape[0] + bits), *shape)
    _assert_qstore_equal(pq.quantize_store(torch.from_numpy(store), bits),
                         jq.quantize_store(store, bits))


def test_quantize_store_in_several_passes(monkeypatch):
    store = _store(np.random.RandomState(1), 50, 8)
    monkeypatch.setattr(pq, "QUANT_CHUNK_ROWS", 16)
    for bits in (8, 4):
        _assert_qstore_equal(pq.quantize_store(torch.from_numpy(store), bits),
                             jq.quantize_store(store, bits))


@pytest.mark.parametrize("bits", [3, 16])
def test_quantize_store_refuses_other_bit_widths_like_jax(bits):
    store = np.ones((4, 8), np.float32)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        jq.quantize_store(store, bits)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        pq.quantize_store(torch.from_numpy(store), bits)


def test_int4_odd_dim_raises_in_both():
    store = np.random.RandomState(2).randn(10, 5).astype(np.float32)
    with pytest.raises(ValueError, match="int4 requires even dim"):
        jq.quantize_store(store, 4)
    with pytest.raises(ValueError, match="int4 requires even dim"):
        pq.quantize_store(torch.from_numpy(store), 4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_model_embeddings_matches_jax(bits):
    jcfg, pcfg = JaxConfig.build(**TWO_GROUPS), DLRMConfig.build(**TWO_GROUPS)
    jgroups = jax_model_groups(jcfg)
    assert [g.pack for g in jgroups] == [8, 8] and len(jgroups) == 2
    jp = jax_init_dlrm(jcfg, seed=3)
    want = jq.quantize_model_embeddings(jp, jgroups, bits)
    params = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    got = pq.quantize_model_embeddings(params, model_groups(pcfg), bits)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_qstore_equal(g, w)
    for g, w in zip(qstores_from_jax(want, "cpu"), want):
        _assert_qstore_equal(g, w)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_rows_within_one_ulp_of_jax(bits):
    rng = np.random.RandomState(6)
    store = _store(rng, 64, 16)
    jqs = jq.quantize_store(store, bits)
    ids = rng.randint(0, 64, (3, 7)).astype(np.int32)
    want = np.asarray(jq.dequantize_rows(jqs, jnp.asarray(ids)))
    got = pq.dequantize_rows(qstores_from_jax([jqs], "cpu")[0], torch.from_numpy(ids))
    assert got.shape == want.shape == (3, 7, 16)
    _within_one_ulp(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("l", [1, 4])
def test_quantized_lookup_group_matches_jax(bits, l):
    jcfg, pcfg = JaxConfig.build(**TWO_GROUPS), DLRMConfig.build(**TWO_GROUPS)
    jg, pg = jax_model_groups(jcfg)[1], model_groups(pcfg)[1]
    jqs = jq.quantize_model_embeddings(jax_init_dlrm(jcfg, seed=4), jax_model_groups(jcfg),
                                       bits)[1]
    _, idx, w, _ = _batch(jcfg.emb_rows, 32, l, seed=l)
    sel = list(jg.table_ids)
    want = np.asarray(jq.quantized_lookup_group(jqs, jg.row_offsets, jnp.asarray(idx[sel]),
                                                jnp.asarray(w[sel])))
    got = pq.quantized_lookup_group(qstores_from_jax([jqs], "cpu")[0], pg.row_offsets,
                                    torch.from_numpy(idx[sel]), torch.from_numpy(w[sel]))
    assert got.shape == want.shape == (len(sel), 32, 16)
    if l == 1:  # one scaled row: the dequantized row times w
        _within_one_ulp(got.numpy(), want)
    else:  # a sum over L in another order
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["int8", "fp16"])
def test_quantize_mlp_matches_jax_bit_for_bit(mode):
    jp = jax_init_dlrm(JaxConfig.build(**TOWERS), seed=1)
    for tower in ("bot", "top"):
        want = jq.quantize_mlp(jp[tower], mode)
        layers = [(torch.tensor(np.asarray(w)), torch.tensor(np.asarray(b)))
                  for w, b in jp[tower]]
        got = pq.quantize_mlp(layers, mode)
        via_convert = qmlp_from_jax(want, "cpu")
        assert got.mode == via_convert.mode == mode
        for (qw, s, b), (cqw, cs, cb), (wqw, ws, wb) in zip(got.layers, via_convert.layers,
                                                             want.layers):
            for t, c, ref in ((qw, cqw, wqw), (s, cs, ws), (b, cb, wb)):
                if ref is None:
                    assert t is None and c is None
                    continue
                assert t.numpy().dtype == np.asarray(ref).dtype
                np.testing.assert_array_equal(t.numpy(), np.asarray(ref))
                np.testing.assert_array_equal(c.numpy(), np.asarray(ref))


def test_quantize_mlp_refuses_an_unknown_mode_like_jax():
    layers = [(np.ones((2, 2), np.float32), np.zeros(2, np.float32))]
    with pytest.raises(ValueError, match="unknown MLP quant mode"):
        jq.quantize_mlp(layers, "int4")
    with pytest.raises(ValueError, match="unknown MLP quant mode"):
        pq.quantize_mlp([tuple(map(torch.from_numpy, layers[0]))], "int4")


@pytest.mark.parametrize("k", [13, 479, 1041, 2500])
def test_int8_accumulators_equal_jax_exactly(k):
    """The first layer's int32 accumulators, at the model's inner lengths
    (13, 479) and past the length at which one f32 product stops being
    exact (1041, 2500: more than one slice)."""
    rng = np.random.RandomState(k)
    w = rng.randn(k, 24).astype(np.float32)
    x = (rng.rand(40, k) * 3).astype(np.float32)
    x[:, : k // 3] = 127.0 / 3  # operands at the top of the int8 range
    jm = jq.quantize_mlp([(w, np.zeros(24, np.float32))], "int8")
    qw = jm.layers[0][0]
    x_scale = jnp.maximum(jnp.max(jnp.abs(x)) / 127.0, 1e-12)
    qx = jnp.clip(jnp.round(x / x_scale), -127, 127).astype(jnp.int8)
    want = np.asarray(jax.lax.dot(qx, qw, preferred_element_type=jnp.int32))
    pm = qmlp_from_jax(jm, "cpu")
    px = torch.from_numpy(x)
    p_scale = torch.clamp_min(px.abs().amax() / 127.0, 1e-12)
    assert p_scale.item() == float(x_scale)
    pqx = torch.clamp(torch.round(px / p_scale), -127, 127)
    np.testing.assert_array_equal(pqx.numpy(), np.asarray(qx, np.float32))
    got = pq.int_product(pqx, pm.layers[0][0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["int8", "fp16"])
@pytest.mark.parametrize("tower", ["bot", "top"])
def test_apply_quantized_mlp_matches_jax(mode, tower):
    """Outputs within rtol 1e-5 / atol 1e-6: the accumulators are exact,
    but the rescale ``acc * (x_scale * w_scale) + b`` may be one FMA in XLA
    and a ReLU or the next layer's activation scale can carry a last-bit
    difference on (fp16: the f32 sums of bf16 products in another order)."""
    jcfg = JaxConfig.build(**TOWERS)
    jp = jax_init_dlrm(jcfg, seed=1)
    jm = jq.quantize_mlp(jp[tower], mode)
    n = int(np.asarray(jp[tower][0][0]).shape[0])
    x = np.random.RandomState(5).rand(32, n).astype(np.float32)
    sig = jcfg.sigmoid_bot if tower == "bot" else jcfg.sigmoid_top
    skip = tower == "top"
    want = np.asarray(jq.apply_quantized_mlp(jnp.asarray(x), jm, sig, skip))
    got = pq.apply_quantized_mlp(torch.from_numpy(x), qmlp_from_jax(jm, "cpu"), sig, skip)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _jax_and_port_state(kw, bits, mode, seed=1):
    jcfg, pcfg = JaxConfig.build(**kw), DLRMConfig.build(**kw)
    jp = jax_init_dlrm(jcfg, seed=seed)
    jgroups = jax_model_groups(jcfg)
    jqs = jq.quantize_model_embeddings(jp, jgroups, bits)
    jbot = jtop = None
    if mode is not None:
        jbot, jtop = jq.quantize_mlp(jp["bot"], mode), jq.quantize_mlp(jp["top"], mode)
    params = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    port = (pcfg, params, qstores_from_jax(jqs, "cpu"),
            None if jbot is None else qmlp_from_jax(jbot, "cpu"),
            None if jtop is None else qmlp_from_jax(jtop, "cpu"))
    return (jcfg, jp, jgroups, jqs, jbot, jtop), port


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", [None, "int8", "fp16"])
@pytest.mark.parametrize("l", [1, 2])
def test_fully_quantized_eval_step_matches_jax(bits, mode, l):
    (jcfg, jp, jgroups, jqs, jbot, jtop), (pcfg, params, pqs, pbot, ptop) = \
        _jax_and_port_state(TOWERS, bits, mode)
    batch = _batch(jcfg.emb_rows, 32, l, seed=7)
    jev = jq.make_fully_quantized_eval_step(jcfg, jgroups, jqs, jbot, jtop)
    want = np.asarray(jev(jp, JaxBatch(*map(jnp.asarray, batch))))
    pev = pq.make_fully_quantized_eval_step(pcfg, model_groups(pcfg), pqs, pbot, ptop, "cpu")
    got = pev(params, Batch(*batch))
    assert got.shape == want.shape == (32, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_eval_step_matches_jax(bits):
    """Quantized tables with the model's float towers; two groups at dim
    16 (packed in JAX) and L=3."""
    (jcfg, jp, jgroups, jqs, _, _), (pcfg, params, pqs, _, _) = \
        _jax_and_port_state(TWO_GROUPS, bits, None)
    batch = _batch(jcfg.emb_rows, 16, 3, seed=8)
    want = np.asarray(jq.make_quantized_eval_step(jcfg, jgroups, jqs)(
        jp, JaxBatch(*map(jnp.asarray, batch))))
    got = pq.make_quantized_eval_step(pcfg, model_groups(pcfg), pqs, "cpu")(params, Batch(*batch))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --- the reference's faults, kept (ROADMAP Queue C 7-9) ---------------------

QR = dict(emb_rows=(300, 40, 500), ln_bot=(4, 8, 2), ln_top=(8, 1), loss="bce",
          qr_flag=True, qr_threshold=200)
MD = dict(emb_rows=(300, 40, 5000), ln_bot=(4, 8, 4), ln_top=(10, 1), loss="bce",
          md_flag=True, emb_dims=(2, 4, 1))


@pytest.mark.parametrize("mode", [None, "int8"])
def test_qr_model_raises_key_error_in_both(mode):
    (jcfg, jp, jgroups, jqs, jbot, jtop), (pcfg, params, pqs, pbot, ptop) = \
        _jax_and_port_state(QR, 8, mode)
    batch = _batch(jcfg.emb_rows, 8, 1, seed=2, m_den=4)
    with pytest.raises(KeyError) as jerr:
        jq.make_fully_quantized_eval_step(jcfg, jgroups, jqs, jbot, jtop)(
            jp, JaxBatch(*map(jnp.asarray, batch)))
    with pytest.raises(KeyError) as perr:
        pq.make_fully_quantized_eval_step(pcfg, model_groups(pcfg), pqs, pbot, ptop, "cpu")(
            params, Batch(*batch))
    assert jerr.value.args == perr.value.args == (0,)


def test_md_model_int4_raises_value_error_in_both():
    jcfg, pcfg = JaxConfig.build(**MD), DLRMConfig.build(**MD)
    jp = jax_init_dlrm(jcfg, seed=1)
    with pytest.raises(ValueError, match="int4 requires even dim"):
        jq.quantize_model_embeddings(jp, jax_model_groups(jcfg), 4)
    params = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    with pytest.raises(ValueError, match="int4 requires even dim"):
        pq.quantize_model_embeddings(params, model_groups(pcfg), 4)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_md_model_raises_type_error_in_both(mode):
    (jcfg, jp, jgroups, jqs, jbot, jtop), (pcfg, params, pqs, pbot, ptop) = \
        _jax_and_port_state(MD, 8, mode)
    batch = _batch(jcfg.emb_rows, 8, 1, seed=2, m_den=4)
    with pytest.raises(TypeError, match="not subscriptable"):
        jq.make_fully_quantized_eval_step(jcfg, jgroups, jqs, jbot, jtop)(
            jp, JaxBatch(*map(jnp.asarray, batch)))
    with pytest.raises(TypeError, match="not subscriptable"):
        pq.make_fully_quantized_eval_step(pcfg, model_groups(pcfg), pqs, pbot, ptop, "cpu")(
            params, Batch(*batch))


def test_learned_pooling_weights_are_ignored_in_both():
    """A trained v_W (here zero on every row of table 0) changes the float
    eval's predictions but not the quantized step's, in either package."""
    kw = dict(TOWERS, weighted_pooling="learned")
    (jcfg, jp, jgroups, jqs, _, _), (pcfg, params, pqs, _, _) = \
        _jax_and_port_state(kw, 8, "int8")
    batch = _batch(jcfg.emb_rows, 16, 1, seed=3)
    jb = JaxBatch(*map(jnp.asarray, batch))
    jev = jq.make_fully_quantized_eval_step(jcfg, jgroups, jqs)
    pev = pq.make_fully_quantized_eval_step(pcfg, model_groups(pcfg), pqs, device="cpu")
    want, got = np.asarray(jev(jp, jb)), pev(params, Batch(*batch)).numpy()
    g0 = jgroups[0]
    t0 = g0.table_ids.index(0)
    off, n = g0.row_offsets[t0], g0.rows[t0]
    jp["vw"][0] = jp["vw"][0].at[off:off + n].set(0.0)
    params["vw"][0][off:off + n] = 0.0
    np.testing.assert_array_equal(np.asarray(jev(jp, jb)), want)
    np.testing.assert_array_equal(pev(params, Batch(*batch)).numpy(), got)
    np.testing.assert_allclose(got, want, **TOL)
    from dlrm_yx_tpu.train.train_step import make_eval_step as jax_make_eval_step

    from dlrm_yx_tpu_torch.train.train_step import make_eval_step

    jfloat = np.asarray(jax_make_eval_step(jcfg)(jp, jb)[0])
    pfloat = make_eval_step(pcfg, "cpu")(params, Batch(*batch))[0].numpy()
    assert not np.allclose(jfloat, want, atol=1e-4)
    np.testing.assert_allclose(pfloat, jfloat, **TOL)
