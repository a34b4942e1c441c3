"""The port's visualization tool (dlrm_yx_tpu_torch.tools.visualize) against
the JAX package's (dlrm_yx_tpu.tools.visualize) on the CPU: the same tables
or the same checkpoint give the same artifacts (file names) and the same
projections, row samples, frequencies and cluster labels, exactly."""

import os

import numpy as np
import pytest

from dlrm_yx_tpu.tools import visualize as jviz
from dlrm_yx_tpu_torch import cli as port_cli
from dlrm_yx_tpu_torch.tools import visualize as pviz

ARCH = ["--arch-embedding-size=300-40-500", "--arch-sparse-feature-size=2",
        "--arch-mlp-bot=4-8-2", "--arch-mlp-top=11-8-1"]


def _assert_same_npz(got_dir, want_dir):
    got, want = sorted(os.listdir(got_dir)), sorted(os.listdir(want_dir))
    assert got == want
    for name in want:
        if not name.endswith(".npz"):
            assert os.path.getsize(os.path.join(got_dir, name)) > 0
            continue
        with np.load(os.path.join(got_dir, name)) as g, np.load(os.path.join(want_dir, name)) as w:
            assert sorted(g.files) == sorted(w.files), name
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")


@pytest.mark.parametrize("methods,cluster,with_freq", [
    (("pca",), True, True),
    (("pca", "tsne", "umap"), False, False),
])
def test_visualize_tables_matches_jax(tmp_path, methods, cluster, with_freq):
    rng = np.random.RandomState(0)
    tables = [rng.randn(80, 8).astype(np.float32), rng.randn(30, 8).astype(np.float32)]
    freqs = [jviz.index_frequencies(rng.randint(0, len(t), 500), len(t)) for t in tables]
    for mod, out in ((jviz, "jax"), (pviz, "port")):
        arts = mod.visualize_tables(tables, str(tmp_path / out), max_rows=50, methods=methods,
                                    do_cluster=cluster, freqs=freqs if with_freq else None)
        assert all(os.path.getsize(p) > 0 for p in arts.values())
    _assert_same_npz(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_main_on_a_port_checkpoint_matches_jax(tmp_path):
    """A checkpoint the port's CLI saved, visualized by both tools with
    frequencies from random loader batches and the per-feature figures."""
    ck = str(tmp_path / "ck")
    port_cli.main(ARCH + ["--mini-batch-size=8", "--num-batches=4", "--loss-function=bce",
                          "--round-targets=True", "--test-freq=4", f"--save-model={ck}",
                          "--device", "cpu"])
    jt = jviz.load_tables_from_checkpoint(ck, jviz_config())
    pt = pviz.load_tables_from_checkpoint(ck, pviz_config())
    assert len(jt) == len(pt) == 3
    for a, b in zip(pt, jt):
        np.testing.assert_array_equal(a, b)
    flags = [f"--load-model={ck}", *ARCH, "--freq-source=random", "--freq-batches=4",
             "--per-feature", "--cluster", "--max-rows=100"]
    jviz.main(flags + [f"--output-dir={tmp_path / 'jax'}"])
    pviz.main(flags + [f"--output-dir={tmp_path / 'port'}"])
    files = os.listdir(tmp_path / "port")
    assert any(f.startswith("cat_counts-") for f in files)
    assert any(f.endswith("_freq.png") for f in files)
    _assert_same_npz(str(tmp_path / "port"), str(tmp_path / "jax"))


def jviz_config():
    from dlrm_yx_tpu.config import DLRMConfig

    return DLRMConfig(emb_rows=(300, 40, 500), ln_bot=(4, 8, 2), ln_top=(8, 11, 8, 1))


def pviz_config():
    from dlrm_yx_tpu_torch.config import DLRMConfig

    return DLRMConfig(emb_rows=(300, 40, 500), ln_bot=(4, 8, 2), ln_top=(8, 11, 8, 1))


def test_per_feature_needs_frequencies_in_both(tmp_path):
    ck = str(tmp_path / "ck")
    port_cli.main(ARCH + ["--mini-batch-size=8", "--num-batches=2", "--test-freq=2",
                          f"--save-model={ck}", "--device", "cpu"])
    flags = [f"--load-model={ck}", *ARCH, "--per-feature", f"--output-dir={tmp_path / 'v'}"]
    for main in (jviz.main, pviz.main):
        with pytest.raises(SystemExit, match="--per-feature needs"):
            main(flags)
