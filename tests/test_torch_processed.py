"""The port's processed-dataset path (``data/processed.py``, the CLI's
``--load-processed`` and ``--data-generation processed``) against the JAX
package on the CPU: the generator's files and the loaded batches bit for
bit, and both CLIs' metrics on the same dataset."""

import json
import os

import numpy as np
import pytest

from dlrm_yx_tpu.cli import main as jax_cli_main
from dlrm_yx_tpu.data import processed as jproc
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.data import processed as pproc


def _write(mod, path, dims, t=5, rows=(200, 3000), pooling=(1, 6), batches=3, b=32, m_den=4,
           seed=7):
    cfgs = mod.gen_table_configs(t, row_range=rows, dim_choices=dims, pooling_range=pooling,
                                 rng=np.random.RandomState(seed))
    data = mod.generate_processed_data(cfgs, m_den, batches, b, seed=seed + 1)
    mod.save_processed(str(path), cfgs, data)
    return cfgs, data


@pytest.mark.parametrize("dims", [(64, 128, 256, 512), (4, 8, 16, 32)])
def test_generator_files_and_batches_match_jax(tmp_path, dims):
    want_cfg, want = _write(jproc, tmp_path / "jax", dims)
    got_cfg, got = _write(pproc, tmp_path / "port", dims)
    assert got_cfg == want_cfg
    assert (tmp_path / "port" / "table_configs.json").read_text() == \
        (tmp_path / "jax" / "table_configs.json").read_text()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # each lookup holds exactly its pooling factor of distinct ids
    for k, tc in enumerate(got_cfg["tables"]):
        pf = tc["pooling_factor"]
        ids = got[0].indices[k, :, :pf]
        assert all(len(np.unique(row)) == pf for row in ids)
        assert (got[0].weights[k, :, pf:] == 0).all() and (got[0].weights[k, :, :pf] == 1).all()
    # the files each package wrote, read by either
    for path in (tmp_path / "jax", tmp_path / "port"):
        jt, jb = jproc.load_processed(str(path))
        pt, pb = pproc.load_processed(str(path))
        assert pt == jt == pproc.load_table_configs(str(path))
        for g, w in zip(pb, jb):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    with np.load(tmp_path / "port" / "data.npz") as a, np.load(tmp_path / "jax" / "data.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_generator_main_matches_jax(tmp_path, capsys):
    args = ["--T", "3", "--m-den", "4", "--num-batches", "2", "--mini-batch-size", "16",
            "--row-range", "100,900", "--dim-range", "16,32", "--pooling-factor-range", "1,8"]
    jproc.main(args + ["--out-dir", str(tmp_path / "jax")])
    pproc.main(args + ["--out-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert out.count("wrote 2 batches x 3 tables to") == 2
    for name in ("table_configs.json", "data.npz"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes() \
            or name == "data.npz"  # zip members carry their write times
    with np.load(tmp_path / "port" / "data.npz") as a, np.load(tmp_path / "jax" / "data.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


CLI = ["--arch-mlp-bot", "4-32-16", "--arch-sparse-feature-size", "16",
       "--arch-mlp-top", "32-1", "--mini-batch-size", "32", "--loss-function", "bce",
       "--learning-rate", "0.05", "--print-freq", "1", "--emb-split-threshold", "1000"]


@pytest.mark.parametrize("dims,extra", [
    ((16, 32), ["--optimizer", "rwsadagrad", "--sparse-update-impl", "pallas"]),
    # three dim groups: the dense branch's three K3 stores in one grouped finish
    ((16, 32, 64), ["--optimizer", "rwsadagrad", "--sparse-update-impl", "pallas"]),
    ((16, 32), ["--optimizer", "sgd", "--data-generation", "processed"]),
    ((4, 8, 16), ["--md-flag", "--optimizer", "rwsadagrad", "--sparse-update-impl",
                  "pallas"]),
    ((2, 8, 16), ["--md-flag", "--md-threshold", "100", "--optimizer", "sgd",
                  "--inference-only"]),
    ((16,), ["--qr-flag", "--qr-threshold", "1000", "--optimizer", "rwsadagrad"]),
])
def test_cli_load_processed_matches_jax_cli(tmp_path, monkeypatch, dims, extra):
    """Both CLIs train (or serve) a dataset the port's generator wrote: the
    model's tables and dims come from table_configs.json (split trick for
    dims 2D, the MD projection for dims below D with --md-flag)."""
    _write(pproc, tmp_path, dims)
    argv = CLI + ["--load-processed", str(tmp_path)] + extra
    want = jax_cli_main(argv)
    got = port_cli.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["streaming_auc"], want["streaming_auc"], atol=1e-6)


@pytest.mark.parametrize("fault", ["tables", "rows"])
def test_cli_exits_on_a_dataset_that_disagrees_like_jax(tmp_path, monkeypatch, fault):
    """data.npz with another table count than table_configs.json, and
    --data-generation processed (the dataset read from the working
    directory) on a hand-given --arch-embedding-size: both CLIs exit."""
    cfgs, data = _write(pproc, tmp_path, (16,))
    if fault == "tables":
        cfgs = {"tables": cfgs["tables"][:-1]}
        with open(os.path.join(tmp_path, "table_configs.json"), "w") as f:
            json.dump(cfgs, f)
        argv = CLI + ["--load-processed", str(tmp_path)]
        match = "tables but the model was built with"
    else:
        monkeypatch.chdir(tmp_path)
        rows = "-".join(str(t["row"] + 1) for t in cfgs["tables"])
        argv = CLI + ["--data-generation", "processed", "--arch-embedding-size", rows]
        match = "table_configs.json rows"
    for main, extra in ((jax_cli_main, []), (port_cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=match):
            main(argv + extra)


def test_md_flag_on_a_dataset_with_dims_above_d_fails_like_jax(tmp_path):
    """ROADMAP Queue C, fault 5: with --md-flag every table over
    --md-threshold whose dim is not D counts as mixed-dimension, one of 2D
    too, and the config refuses it (dim exceeds the base dim) in both
    packages: --load-processed with --md-flag takes datasets of dims <= D."""
    _write(pproc, tmp_path, (16, 32))
    argv = CLI + ["--load-processed", str(tmp_path), "--md-flag"]
    for main, extra in ((jax_cli_main, []), (port_cli.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="exceeds base dim 16"):
            main(argv + extra)
