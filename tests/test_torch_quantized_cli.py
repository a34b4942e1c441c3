"""Quantized serving through both CLIs (``--inference-only --load-model``
with ``--quantize-emb-with-bit`` / ``--quantize-mlp-with-bit``) on the CPU.

One checkpoint, saved by the port's CLI (it cross-loads into the JAX
package), is served by both CLIs at tables 4 / 8 bits x towers 8 / 16 / 32
bits. Each CLI's quantized eval step is wrapped to keep its predictions:
they agree within rtol 1e-5 / atol 1e-6 (tests/test_torch_quantized.py
says why not bit for bit), and the accuracies agree except for the
predictions that lie within that tolerance of the 0.5 threshold, each of
which may round the other way.
"""

import numpy as np
import pytest

import dlrm_yx_tpu.ops.quantized as jq
import dlrm_yx_tpu_torch.cli as port_cli
from dlrm_yx_tpu.cli import main as jax_cli_main

TOL = dict(rtol=1e-5, atol=1e-6)
BORDER = 1e-5  # a prediction this close to 0.5 may round either way
ARCH = ["--arch-embedding-size=300-40-500", "--arch-mlp-bot=4-8-2",
        "--arch-mlp-top=11-8-1", "--arch-sparse-feature-size=2",
        "--mini-batch-size=64", "--num-batches=4", "--loss-function=bce",
        "--round-targets=True"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("qcli") / "ck")
    port_cli.main(ARCH + ["--test-freq=4", f"--save-model={ck}", "--learning-rate=0.5",
                          "--device", "cpu"])
    return ck


def _recording(make, preds, to_numpy):
    def wrapped(*a, **k):
        ev = make(*a, **k)

        def step(params, batch):
            out = ev(params, batch)
            preds.append(to_numpy(out))
            return out

        return step

    return wrapped


@pytest.mark.parametrize("emb_bits", [4, 8])
@pytest.mark.parametrize("mlp_bits", [8, 16, 32])
def test_both_clis_serve_quantized_alike(monkeypatch, checkpoint, emb_bits, mlp_bits):
    flags = ARCH + ["--inference-only", f"--load-model={checkpoint}",
                    f"--quantize-emb-with-bit={emb_bits}", f"--quantize-mlp-with-bit={mlp_bits}"]
    jax_preds, port_preds = [], []
    monkeypatch.setattr(jq, "make_fully_quantized_eval_step", _recording(
        jq.make_fully_quantized_eval_step, jax_preds, lambda p: np.asarray(p).ravel()))
    monkeypatch.setattr(port_cli, "make_fully_quantized_eval_step", _recording(
        port_cli.make_fully_quantized_eval_step, port_preds, lambda p: p.numpy().ravel()))
    want = jax_cli_main(flags)
    got = port_cli.main(flags + ["--device", "cpu"])
    assert set(got) == set(want) == {"accuracy", "quantized"}
    assert got["quantized"] is want["quantized"] is True
    jp, pp = np.concatenate(jax_preds), np.concatenate(port_preds)
    assert jp.shape == pp.shape == (4 * 64,)
    np.testing.assert_allclose(pp, jp, **TOL)
    border = int((np.abs(jp - 0.5) <= BORDER).sum())
    assert abs(got["accuracy"] - want["accuracy"]) * len(jp) <= border + 1e-9


def test_other_bit_widths_serve_the_float_model_in_both(checkpoint):
    """--quantize-emb-with-bit 16 and --quantize-mlp-with-bit 4 select
    nothing: both CLIs take the float eval."""
    flags = ARCH + ["--inference-only", f"--load-model={checkpoint}",
                    "--quantize-emb-with-bit=16", "--quantize-mlp-with-bit=4"]
    want = jax_cli_main(flags)
    got = port_cli.main(flags + ["--device", "cpu"])
    assert "quantized" not in got and "quantized" not in want
    assert got["accuracy"] == want["accuracy"]
