"""``--debug-mode`` and ``--print-precision`` in both CLIs on the CPU, on
the JAX CLI's own example (``--mini-batch-size=2 --data-size=6``, the
default 4-3-2 model). The printout of the model and its initial parameters
is the JAX CLI's, line for line; the printout after training is parsed and
its numbers held to the JAX CLI's at rtol 1e-5 / atol 1e-6 (the f32
training steps of the two packages sum in other orders)."""

import contextlib
import io
import re

import numpy as np
import pytest

from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu_torch import cli as port_cli

FLAGS = ["--mini-batch-size=2", "--data-size=6", "--debug-mode"]
NUMBER = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def _printed(main, flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(flags)
    return out.getvalue()


def _sections(text):
    """(the initial printout, the updated printout): from "model arch:" to
    the first training line, and everything after "updated parameters"."""
    head, updated = text.split("updated parameters (weights and bias):\n")
    initial = head[head.index("model arch:"):head.index("Finished training it")]
    return initial.splitlines(), updated.splitlines()


@pytest.mark.parametrize("extra", [[], ["--print-precision", "3"],
                                   ["--print-precision", "7", "--round-targets=True",
                                    "--loss-function=bce", "--learning-rate=0.1"]])
def test_debug_printout_matches_jax_cli(extra):
    want_initial, want_updated = _sections(_printed(jax_cli_main, FLAGS + extra))
    got_initial, got_updated = _sections(_printed(port_cli.main,
                                                  FLAGS + extra + ["--device", "cpu"]))
    assert len(want_initial) > 20
    assert got_initial == want_initial
    # the same lines, the same text apart from the numbers
    assert [NUMBER.sub("#", x) for x in got_updated] == [NUMBER.sub("#", x) for x in want_updated]
    got = np.array([float(v) for x in got_updated for v in NUMBER.findall(x)])
    want = np.array([float(v) for x in want_updated for v in NUMBER.findall(x)])
    assert got.shape == want.shape and got.size > 50
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_debug_mode_prints_before_serving_in_both():
    flags = FLAGS + ["--inference-only"]
    want = _printed(jax_cli_main, flags)
    got = _printed(port_cli.main, flags + ["--device", "cpu"])
    cut = "initial parameters"
    assert cut in want
    assert got[got.index("model arch:"):got.index("inference metrics")] == \
        want[want.index("model arch:"):want.index("inference metrics")]


def test_only_the_mesh_flags_are_left_unported():
    """The flags ported here keep the JAX CLI's types and defaults (the
    trace directory sits under the temporary directory, /tmp as in JAX
    unless TMPDIR says otherwise)."""
    import os
    import tempfile

    from dlrm_yx_tpu.cli import build_parser as jax_parser

    jax_args = vars(jax_parser().parse_args([]))
    port_args = vars(port_cli.build_parser().parse_args([]))
    # every JAX flag is declared (the port adds --device, DLRM-DCNv2's flags
    # and HSTU's, models the JAX package does not have), and every shard
    # mode runs with a mesh (row and column sharding were the last)
    hstu = {"model"} | {k for k in port_args if k.startswith("hstu_")}
    assert hstu == {"model", "hstu_num_items", "hstu_embedding_dim", "hstu_num_heads",
                    "hstu_attention_dim", "hstu_linear_dim", "hstu_num_blocks",
                    "hstu_max_seq_len", "hstu_num_negatives", "hstu_temperature",
                    "hstu_tokens_per_batch", "hstu_max_sequences"}
    assert set(port_args) - set(jax_args) == {"device", "dcn_num_layers", "dcn_low_rank_dim",
                                              "multi_hot_sizes"} | hstu
    assert set(jax_args) <= set(port_args)
    for mode in ("table", "row", "col"):
        port_cli.check_ported(port_cli.build_parser().parse_args(
            ["--mesh-model=2", f"--shard-mode={mode}", "--debug-mode",
             "--collect-execution-graph"]))
    for flag in ("print-precision", "debug-mode", "enable-profiling", "plot-compute-graph",
                 "collect-execution-graph", "save-onnx", "quantize-mlp-with-bit",
                 "quantize-emb-with-bit"):
        key = flag.replace("-", "_")
        assert port_args[key] == jax_args[key] and type(port_args[key]) is type(jax_args[key])
    assert port_args["profile_out_dir"] == os.path.join(tempfile.gettempdir(), "dlrm_tpu_trace")
