"""The port's CLI (dlrm_yx_tpu_torch/cli.py) against the JAX CLI on the
reference-compat flags that dlrm_yx_tpu/cli.py accepts as no-ops: the port
accepts them with the same types and defaults, reads none of them, and gives
the JAX CLI's metrics on a command line that carries them. Flags whose parts
are not ported keep raising (tests/test_torch_serving.py)."""

import numpy as np
import pytest

from dlrm_yx_tpu.cli import build_parser as jax_build_parser
from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu_torch import cli as port_cli

# each no-op flag with a value that is not its default
NOOP_FLAGS = {
    "--use-gpu": [],
    "--use-tpu": [],
    "--activation-function": ["sigmoid"],
    "--num-workers": ["4"],
    "--test-num-workers": ["2"],
    "--pin-memory": [],
    "--sync-dense-params": [""],
    "--bucket-size-mb": ["50"],
    "--dist-backend": ["nccl"],
    "--local-rank": ["0"],
    "--early-barrier": [],
    "--aggregated-allreduce": [],
    "--batched-emb": [],
    "--fbgemm-emb": [],
}

SERVE = [
    "--arch-embedding-size", "100-200-1000-37", "--arch-sparse-feature-size", "128",
    "--arch-mlp-bot", "13-64-128", "--arch-mlp-top", "64-1",
    "--emb-split-threshold", "150", "--num-batches", "2",
    "--num-indices-per-lookup", "1", "--loss-function", "bce",
    "--inference-only", "--interaction-impl", "pallas",
    "--compute-dtype", "float32", "--mini-batch-size", "128",
]

TRAIN = [
    "--arch-embedding-size", "40-3000", "--arch-sparse-feature-size", "16",
    "--arch-mlp-bot", "4-16", "--arch-mlp-top", "8-1", "--mini-batch-size", "64",
    "--num-batches", "3", "--num-indices-per-lookup", "2", "--optimizer", "rwsadagrad",
    "--sparse-update-impl", "pallas", "--emb-split-threshold", "100",
    "--loss-function", "bce",
]


def _dest(flag):
    return flag[2:].replace("-", "_")


def test_noop_flags_keep_the_jax_types_and_defaults():
    jax_args = jax_build_parser().parse_args([])
    port_args = port_cli.build_parser().parse_args([])
    for flag in NOOP_FLAGS:
        assert getattr(port_args, _dest(flag)) == getattr(jax_args, _dest(flag)), flag
    flags = [a for flag, vals in NOOP_FLAGS.items() for a in [flag, *vals]]
    jax_args = jax_build_parser().parse_args(flags)
    port_args = port_cli.build_parser().parse_args(flags)
    for flag in NOOP_FLAGS:
        got = getattr(port_args, _dest(flag))
        assert got == getattr(jax_args, _dest(flag)) != getattr(
            jax_build_parser().parse_args([]), _dest(flag)), flag
        assert flag[2:] not in port_cli.UNPORTED_FLAGS


def _assert_same_metrics(got, want):
    assert set(got) == set(want)
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["streaming_auc"] - want["streaming_auc"]) <= 1e-6


@pytest.mark.parametrize("flag", list(NOOP_FLAGS))
def test_cli_inference_with_noop_flag_matches_jax_cli(flag):
    flags = SERVE + [flag, *NOOP_FLAGS[flag]]
    want = jax_cli_main(flags)
    got = port_cli.main(flags + ["--device", "cpu"])
    _assert_same_metrics(got, want)


def test_cli_training_with_every_noop_flag_matches_jax_cli():
    """All fourteen on one training command line: the same metrics as the
    JAX CLI, and as the port without them."""
    noop = [a for flag, vals in NOOP_FLAGS.items() for a in [flag, *vals]]
    want = jax_cli_main(TRAIN + noop)
    got = port_cli.main(TRAIN + noop + ["--device", "cpu"])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["streaming_auc"], want["streaming_auc"], atol=1e-6)
    plain = port_cli.main(TRAIN + ["--device", "cpu"])
    assert got == plain


@pytest.mark.parametrize("extra", [["--enable-profiling"], ["--md-flag"]])
def test_unported_flags_still_raise_beside_noop_flags(extra):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_cli.main(SERVE + ["--use-gpu", "--pin-memory"] + extra + ["--device", "cpu"])
