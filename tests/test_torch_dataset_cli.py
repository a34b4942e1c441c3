"""The port's CLI on real-format data against the JAX CLI on the same tiny
files: the Kaggle TSV preprocessed on first touch, the day npz files with
and without --memory-map, the MLPerf binary loader with its shuffle, the
stack-distance trace generator (--data-generation synthetic), and
checkpoints (--save-model, --load-model, --inference-only --load-model).
Table rows derived from the counts are equal; losses and accuracy agree at
rtol 1e-5 / atol 1e-6 and streaming_auc at atol 1e-6. The two faults of the
JAX CLI on this path (ROADMAP Queue C) raise the same exception type in
both.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

from dlrm_yx_tpu.cli import build_parser as jax_build_parser
from dlrm_yx_tpu.cli import config_from_args as jax_config_from_args
from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu.data import synth_kaggle
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.data import fastparse
from dlrm_yx_tpu_torch.data.criteo import convert_days_to_memmap
from dlrm_yx_tpu_torch.data.criteo_bin import npz_to_binary
from torch_hybrid_cases import MESH_FLAGS

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAY_ROWS = 64

MODEL = ["--arch-sparse-feature-size", "16", "--arch-mlp-bot", "13-16-16",
         "--arch-mlp-top", "16-1", "--loss-function", "bce", "--round-targets", "True",
         "--learning-rate", "0.1", "--mini-batch-size", "16"]


def _run(main, flags, capsys, device=True):
    capsys.readouterr()
    metrics = main(flags + (["--device", "cpu"] if device else []))
    out = capsys.readouterr().out
    return metrics, [float(x) for x in re.findall(r"loss ([-+.\deE]+)", out)], out


def _both(flags, capsys):
    """(port, JAX) of (metrics, printed losses, output) on one command line."""
    return _run(port_cli.main, flags, capsys), _run(jax_cli_main, flags, capsys, device=False)


def _assert_close(got, want):
    (gm, gl, _), (wm, wl, _) = got, want
    assert len(gl) == len(wl) > 0
    np.testing.assert_allclose(gl, wl, **TOL)
    assert set(gm) == set(wm)
    for k in gm:
        if k == "streaming_auc":
            np.testing.assert_allclose(gm[k], wm[k], atol=1e-6)
        else:
            np.testing.assert_allclose(gm[k], wm[k], **TOL)


def _rows(flags):
    port = port_cli.config_from_args(port_cli.build_parser().parse_args(flags), flags)
    jax_cfg = jax_config_from_args(jax_build_parser().parse_args(flags))
    assert tuple(port.emb_rows) == tuple(jax_cfg.emb_rows)
    return port.emb_rows


@pytest.fixture(scope="module")
def kaggle(tmp_path_factory):
    """A 7-day Kaggle train.txt from the generator, one copy per package
    (each CLI preprocesses its own on first touch)."""
    d = tmp_path_factory.mktemp("kaggle")
    synth_kaggle.generate(str(d / "train.txt"), 7 * DAY_ROWS, seed=2, signal_scale=1.8)
    for name in ("port", "jax", "shared"):
        os.makedirs(d / name)
        shutil.copy(d / "train.txt", d / name / "train.txt")
    return d


def _kaggle_flags(d, name, *extra):
    return MODEL + ["--data-generation", "dataset", "--data-set", "kaggle",
                    "--raw-data-file", str(d / name / "train.txt"),
                    "--processed-data-file", str(d / name / "kaggle"),
                    "--test-mini-batch-size", "32", "--print-freq", "4",
                    "--test-freq", "8", *extra]


@pytest.fixture(scope="module")
def preprocessed(kaggle):
    """The prefix of the day files that the port preprocessed, shared by
    the tests past the first touch."""
    args = port_cli.build_parser().parse_args(_kaggle_flags(kaggle, "shared"))
    port_cli.ensure_preprocessed(args)
    return str(kaggle / "shared" / "kaggle")


def test_kaggle_tsv_preprocessed_on_first_touch(kaggle, capsys):
    before = fastparse.calls["parse_raw_tsv"]
    got = _run(port_cli.main, _kaggle_flags(kaggle, "port", "--print-wall-time"), capsys)
    want = _run(jax_cli_main, _kaggle_flags(kaggle, "jax"), capsys, device=False)
    assert fastparse.calls["parse_raw_tsv"] == before + 7  # the native parser, a day each
    assert "preprocessing" in got[2] and "Total wall time:" in got[2]
    _assert_close(got, want)
    for art in ["day_count", "fea_count"] + [f"day_{i}_reordered" for i in range(7)]:
        with np.load(kaggle / "port" / f"kaggle_{art}.npz") as a, \
                np.load(kaggle / "jax" / f"kaggle_{art}.npz") as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    rows = _rows(_kaggle_flags(kaggle, "port"))
    with np.load(kaggle / "port" / "kaggle_fea_count.npz") as d:
        assert list(rows) == d["counts"].tolist() and len(rows) == 26
    capped = _rows(_kaggle_flags(kaggle, "port", "--max-ind-range", "40",
                                 "--arch-embedding-size", "5-5"))
    assert max(capped) == 40 and len(capped) == 26


@pytest.mark.parametrize("memory_map", [False, True])
def test_kaggle_npz_and_memory_map(kaggle, preprocessed, capsys, memory_map):
    flags = MODEL + ["--data-generation", "dataset", "--processed-data-file", preprocessed,
                     "--print-freq", "4", "--test-freq", "8", "--max-ind-range", "50"]
    plain = _both(flags, capsys)
    _assert_close(*plain)
    if memory_map:
        convert_days_to_memmap(preprocessed, 7)
        mapped = _both(flags + ["--memory-map"], capsys)
        _assert_close(*mapped)
        assert mapped[0][1] == plain[0][1] and mapped[0][0] == plain[0][0]


@pytest.fixture(scope="module")
def train_bin(kaggle, preprocessed):
    """The MLPerf binary file of six days (6 × 64 records: 20 batches of 20,
    the last one short) with its counts npz at the file's prefix."""
    path = str(kaggle / "train.bin")
    npz_to_binary([f"{preprocessed}_day_{i}_reordered.npz" for i in range(6)], path)
    shutil.copy(f"{preprocessed}_fea_count.npz", f"{path}_fea_count.npz")
    return path


BIN = ["--data-generation", "dataset", "--data-set", "terabyte", "--mlperf-bin-loader",
       "--mini-batch-size", "20"]


def _bin_flags(path, *extra):
    return MODEL + BIN + [
        "--raw-data-file", path, "--max-ind-range", "100", "--print-freq", "1",
        "--steps-per-dispatch", "1", *extra]


@pytest.mark.parametrize("shuffle", [False, True])
def test_bin_loader(train_bin, capsys, shuffle):
    """Two epochs (a new batch order each with the shuffle), the short
    batch among them; --sparse-update-impl pallas measures the density
    hint on the loader's first batch, through the shuffle order."""
    flags = _bin_flags(train_bin, "--nepochs", "2", "--sparse-update-impl", "pallas",
                       "--optimizer", "rwsadagrad", "--emb-split-threshold", "50",
                       *(["--mlperf-bin-shuffle"] if shuffle else []))
    got, want = _both(flags, capsys)
    _assert_close(got, want)
    assert len(got[1]) == 2 * 20
    hint = re.findall(r"duplicate-density hint from first batch: ([.\d]+)", got[2])
    assert hint and hint == re.findall(r"duplicate-density hint from first batch: ([.\d]+)",
                                       want[2])
    rows = _rows(flags)
    assert max(rows) == 100


def test_bin_loader_with_processed_data_file_fails_as_in_jax(train_bin, tmp_path):
    """Fault 1 of the reference (ROADMAP Queue C): bench/run_and_time.sh
    passes its test .bin through --processed-data-file, which both CLIs
    hand to np.load as the counts file."""
    test_bin = str(tmp_path / "test.bin")
    shutil.copy(train_bin, test_bin)
    flags = _bin_flags(train_bin, "--processed-data-file", test_bin)
    for main, extra in ((port_cli.main, ["--device", "cpu"]), (jax_cli_main, [])):
        with pytest.raises(ValueError, match="pickled"):
            main(flags + extra)


def test_short_batch_inside_a_dispatch_group_fails_as_in_jax(train_bin):
    """Fault 2 of the reference (ROADMAP Queue C): at 4 steps a dispatch
    every group of the 20 batches is full, so the short one is stacked
    with full ones, and np.stack raises in both trainers."""
    flags = _bin_flags(train_bin, "--mlperf-bin-shuffle")
    flags[flags.index("--steps-per-dispatch") + 1] = "4"
    for main, extra in ((port_cli.main, ["--device", "cpu"]), (jax_cli_main, [])):
        with pytest.raises(ValueError, match="same shape"):
            main(flags + extra)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad"])
def test_trace_path(capsys, optimizer):
    """--data-generation synthetic on the shipped dist files (3, wrapped
    over 4 tables)."""
    flags = ["--arch-embedding-size", "300-5000-40-80000", "--arch-sparse-feature-size", "16",
             "--arch-mlp-bot", "4-16", "--arch-mlp-top", "8-1", "--data-generation", "synthetic",
             "--data-trace-file", os.path.join(REPO, "input", "dist_emb_j.log"),
             "--mini-batch-size", "32", "--num-batches", "4", "--num-indices-per-lookup", "1",
             "--loss-function", "bce", "--print-freq", "2", "--optimizer", optimizer,
             "--sparse-update-impl", "pallas", "--emb-split-threshold", "1000"]
    got, want = _both(flags, capsys)
    _assert_close(got, want)
    assert "duplicate-density hint" in got[2]


def test_checkpoint_save_resume_and_serve(kaggle, preprocessed, tmp_path, capsys):
    """Save-on-best at the first eval of a run stopped there (accuracy
    threshold), resume it, and serve it: the resumed losses equal the
    uninterrupted run's from the saved iteration on (bit for bit in the
    port, at rtol 1e-5 against JAX's resumed run); the served metrics
    equal those of the eval that saved it."""
    flags = MODEL + ["--data-generation", "dataset", "--processed-data-file", preprocessed,
                     "--print-freq", "4", "--test-freq", "8", "--optimizer", "adagrad"]
    straight = _run(port_cli.main, flags, capsys)
    runs = {}
    for name, main, extra in (("port", port_cli.main, True), ("jax", jax_cli_main, False)):
        ck = str(tmp_path / name)
        part = _run(main, flags + ["--save-model", ck, "--mlperf-acc-threshold", "1e-9"],
                    capsys, extra)
        meta = json.load(open(os.path.join(ck, "meta.json")))
        assert meta["iteration"] == 8 and meta["optimizer"] == "adagrad"
        resumed = _run(main, flags + ["--load-model", ck], capsys, extra)
        assert "Resumed checkpoint at epoch 0 iteration 8" in resumed[2]
        served = _run(main, flags + ["--load-model", ck, "--inference-only"], capsys, extra)
        runs[name] = (part, resumed, served, meta)
    (part, resumed, served, meta), jax_runs = runs["port"], runs["jax"]
    assert part[1] == straight[1][:2]
    assert resumed[1] == straight[1][2:] and resumed[0] == straight[0]
    assert served[0] == meta["metrics"]
    for got, want in zip((part, resumed), jax_runs[:2]):
        _assert_close(got, want)
    assert set(served[0]) == set(jax_runs[2][0])
    for k in served[0]:
        np.testing.assert_allclose(served[0][k], jax_runs[2][0][k], **TOL)


def test_orbax_backend_raises(capsys):
    flags = ["--arch-embedding-size", "20-30", "--arch-mlp-bot", "4-2", "--arch-mlp-top", "2-1",
             "--num-batches", "1", "--ckpt-backend", "orbax", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="Orbax is a JAX library"):
        port_cli.main(flags)


def test_ported_flags_keep_the_jax_types_and_defaults():
    ported = ["data-trace-file", "data-trace-enable-padding", "data-set", "raw-data-file",
              "processed-data-file", "data-randomize", "data-sub-sample-rate", "memory-map",
              "mlperf-bin-loader", "mlperf-bin-shuffle", "dataset-multiprocessing",
              "test-mini-batch-size", "save-model", "load-model", "ckpt-backend",
              "tensor-board-filename", "print-wall-time"]
    jax_args = vars(jax_build_parser().parse_args([]))
    port_args = vars(port_cli.build_parser().parse_args([]))
    for flag in ported:
        assert flag not in MESH_FLAGS
        key = flag.replace("-", "_")
        assert port_args[key] == jax_args[key], flag
