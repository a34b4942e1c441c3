"""The port's data sources (dlrm_yx_tpu_torch/data/: criteo, fastparse,
criteo_bin, synth_kaggle, trace) against the JAX package's on the same
inputs. Both sides are numpy (and the same C++ parser, each package built
its own copy), so everything is held to exact equality: file bytes,
artifact arrays, batches. The native and the numpy paths are each compared
across the packages (they keep different sub-sampled row sets by design)."""

import os

import numpy as np
import pytest

from dlrm_yx_tpu.data import criteo as jc
from dlrm_yx_tpu.data import criteo_bin as jb
from dlrm_yx_tpu.data import fastparse as jfp
from dlrm_yx_tpu.data import synth_kaggle as jsk
from dlrm_yx_tpu.data import trace as jt
from dlrm_yx_tpu_torch.data import criteo as pc
from dlrm_yx_tpu_torch.data import criteo_bin as pb
from dlrm_yx_tpu_torch.data import fastparse as pfp
from dlrm_yx_tpu_torch.data import synth_kaggle as psk
from dlrm_yx_tpu_torch.data import trace as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in g._fields:
            a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, (a, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{a}:{k}")


def _native(monkeypatch, on):
    """Both packages' parsers native (on) or numpy (off)."""
    if on:
        assert pfp.available() and jfp.available()
    for mod in (pfp, jfp):
        monkeypatch.setattr(mod, "available", lambda on=on: on)


@pytest.fixture(scope="module")
def raw_tsv(tmp_path_factory):
    """A Kaggle-format TSV from the JAX generator, 7 × 120 rows."""
    d = tmp_path_factory.mktemp("tsv")
    path = str(d / "train.txt")
    jsk.generate(path, 840, seed=11, chunk=300)
    return path


def test_native_parser_builds_into_the_build_dir():
    assert pfp.available()
    so = pfp.lib_path()
    assert so.exists() and so.parent.parent.name == "build"
    assert so.parent.parent.parent == type(so)(REPO)


@pytest.mark.parametrize("chunk", [200_000, 700])
def test_synth_kaggle_writes_the_same_bytes(tmp_path, chunk):
    got, want = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    sp = psk.generate(got, 2000, seed=3, chunk=chunk)
    sj = jsk.generate(want, 2000, seed=3, chunk=chunk)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    assert sp["rows"] == sj["rows"] and sp["ctr"] == sj["ctr"]
    assert psk.VOCAB_SIZES == jsk.VOCAB_SIZES


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("mir,rate", [(-1, 0.0), (1000, 0.0), (-1, 0.5)])
def test_parse_raw_tsv(monkeypatch, raw_tsv, native, mir, rate):
    """The generator's ids are 32-bit hashes: without --max-ind-range the
    numpy path of both packages raises on those of 2**31 and up (numpy 2
    refuses the int32 store; the native parser wraps them), ROADMAP
    Queue C."""
    _native(monkeypatch, native)
    if not native and mir < 0:
        for pkg in (pc, jc):
            with pytest.raises(OverflowError):
                pkg.parse_raw_tsv(raw_tsv, mir, rate, seed=7)
        return
    calls = pfp.calls["parse_raw_tsv"]
    got = pc.parse_raw_tsv(raw_tsv, mir, rate, seed=7)
    want = jc.parse_raw_tsv(raw_tsv, mir, rate, seed=7)
    assert pfp.calls["parse_raw_tsv"] == calls + native
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if rate == 0.0 and mir > 0:  # without sub-sampling the native parse is the numpy one
        monkeypatch.setattr(pfp, "available", lambda: not native)
        for a, b in zip(pc.parse_raw_tsv(raw_tsv, mir, rate, seed=7), got):
            np.testing.assert_array_equal(a, b)


def test_split_kaggle_train_txt(tmp_path, raw_tsv):
    for pkg, name in ((pc, "port"), (jc, "jax")):
        os.makedirs(tmp_path / name)
        src = str(tmp_path / name / "train.txt")
        with open(raw_tsv, "rb") as f, open(src, "wb") as g:
            g.write(f.read())
        files = pkg.split_kaggle_train_txt(src, 7)
        assert [os.path.basename(f) for f in files] == [f"train_day_{i}.txt" for i in range(7)]
    for i in range(7):
        with open(tmp_path / "port" / f"train_day_{i}.txt", "rb") as f, \
                open(tmp_path / "jax" / f"train_day_{i}.txt", "rb") as g:
            assert f.read() == g.read()


def _day_files(d, raw_tsv, days=7):
    src = str(d / "train.txt")
    with open(raw_tsv, "rb") as f, open(src, "wb") as g:
        g.write(f.read())
    return jc.split_kaggle_train_txt(src, days)


ARTIFACTS = (["day_count", "fea_count"] + [f"fea_dict_{j}" for j in range(26)]
             + [f"day_{i}{s}" for i in range(7) for s in ("", "_processed", "_reordered")])


@pytest.mark.parametrize("randomize,native,rate,nprocs", [
    ("none", True, 0.0, 1),
    ("day", True, 0.3, 2),
    ("total", False, 0.0, 1),
])
def test_preprocess_criteo(monkeypatch, tmp_path, raw_tsv, randomize, native, rate, nprocs):
    _native(monkeypatch, native)
    files = _day_files(tmp_path, raw_tsv)
    info = {}
    for pkg, name in ((pc, "port"), (jc, "jax")):
        info[name] = pkg.preprocess_criteo(files, str(tmp_path / name), max_ind_range=5000,
                                           sub_sample_rate=rate, randomize=randomize,
                                           seed=5, nprocs=nprocs)
    np.testing.assert_array_equal(info["port"]["counts"], info["jax"]["counts"])
    np.testing.assert_array_equal(info["port"]["total_per_file"], info["jax"]["total_per_file"])
    for art in ARTIFACTS:
        _same_npz(f"{tmp_path}/port_{art}.npz", f"{tmp_path}/jax_{art}.npz")
    if rate:
        assert sum(info["port"]["total_per_file"]) < 840


@pytest.fixture(scope="module")
def processed(tmp_path_factory, raw_tsv):
    """The JAX pipeline's artifacts of the 7-day TSV, with the memory-map
    .npy files."""
    d = tmp_path_factory.mktemp("proc")
    prefix = str(d / "kaggle")
    jc.preprocess_criteo(_day_files(d, raw_tsv), prefix, randomize="total", seed=5)
    pc.convert_days_to_memmap(prefix, 7)
    return prefix


def test_convert_days_to_memmap(tmp_path, processed):
    prefix = str(tmp_path / "k")
    for i in range(7):
        with open(f"{processed}_day_{i}_reordered.npz", "rb") as f, \
                open(f"{prefix}_day_{i}_reordered.npz", "wb") as g:
            g.write(f.read())
    jc.convert_days_to_memmap(prefix, 7)
    for i in range(7):
        for k in ("X_cat", "X_int", "y"):
            with open(f"{processed}_day_{i}_{k}.npy", "rb") as f, \
                    open(f"{prefix}_day_{i}_{k}.npy", "rb") as g:
                assert f.read() == g.read()


@pytest.mark.parametrize("split", ["train", "test", "val"])
@pytest.mark.parametrize("memory_map", [False, True])
@pytest.mark.parametrize("mir,drop_last,b", [(-1, True, 32), (50, False, 48)])
def test_npz_loader(processed, split, memory_map, mir, drop_last, b):
    kw = dict(split=split, max_ind_range=mir, drop_last=drop_last, memory_map=memory_map)
    got = pc.CriteoNpzLoader(processed, 7, b, **kw)
    want = jc.CriteoNpzLoader(processed, 7, b, **kw)
    assert len(got) == len(want) and got.length == want.length
    _same_batches(got, want)
    if mir > 0:
        assert max(int(x.indices.max()) for x in got) < mir


def test_transform_dense():
    x = np.random.RandomState(0).randint(0, 10**6, (64, 13)).astype(np.int32)
    got, want = pc.transform_dense(x), jc.transform_dense(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def train_bin(tmp_path_factory, processed):
    """npz_to_binary of six days (840 rows minus the last day: not a whole
    number of batches of 64, so the last batch is short)."""
    d = tmp_path_factory.mktemp("bin")
    days = [f"{processed}_day_{i}_reordered.npz" for i in range(6)]
    got, want = str(d / "port.bin"), str(d / "jax.bin")
    pb.npz_to_binary(days, got)
    jb.npz_to_binary(days, want)
    return got, want, days


def test_npz_to_binary(tmp_path, train_bin, processed):
    got, want, _ = train_bin
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    last = [f"{processed}_day_6_reordered.npz"]
    for split in ("test", "val"):
        a, b = str(tmp_path / f"p_{split}.bin"), str(tmp_path / f"j_{split}.bin")
        pb.npz_to_binary(last, a, split=split)
        jb.npz_to_binary(last, b, split=split)
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("shuffle_seed,mir", [(None, -1), (9, 40)])
def test_bin_loader(monkeypatch, train_bin, processed, native, shuffle_seed, mir):
    _native(monkeypatch, native)
    path, _, _ = train_bin
    kw = dict(batch_size=64, max_ind_range=mir, shuffle_seed=shuffle_seed)
    counts = f"{processed}_fea_count.npz"
    reads = pfp.calls["read_bin_batch"]
    got = pb.CriteoBinLoader(path, counts, **kw)
    want = jb.CriteoBinLoader(path, counts, **kw)
    records = os.path.getsize(path) // (4 * 40)
    assert len(got) == len(want) == -(-records // 64) and records % 64
    np.testing.assert_array_equal(got.counts, want.counts)
    _same_batches(got, want)
    sizes = sorted(len(b.labels) for b in got)
    assert sizes[0] < 64 == sizes[-1]  # one short batch
    _same_batches([got[0], got[len(got) - 1]], [want[0], want[len(want) - 1]])
    if shuffle_seed is not None:
        got.reshuffle(1)
        want.reshuffle(1)
        np.testing.assert_array_equal(got._order, want._order)
        _same_batches(got, want)
    assert pfp.calls["read_bin_batch"] > reads if native else pfp.calls["read_bin_batch"] == reads


def test_bin_loader_counts_file_that_is_not_npz(train_bin):
    """The reference's MLPerf line passes its test .bin as the counts file:
    np.load raises ValueError in both packages (ROADMAP Queue C)."""
    path, _, _ = train_bin
    for pkg in (pb, jb):
        with pytest.raises(ValueError, match="pickled"):
            pkg.CriteoBinLoader(path, path, batch_size=64)


def test_trace_profile_and_generators():
    rng = np.random.RandomState(3)
    trace = rng.zipf(1.3, 400) % 60
    got, want = pt.trace_profile(trace), jt.trace_profile(trace)
    assert got == want
    stack, dists, lines = got
    assert pt.dist_from_distances(dists) == jt.dist_from_distances(dists)
    vals, cum = jt.dist_from_distances(dists)
    for gen in ("trace_generate_lru", "trace_generate_rand"):
        for pad in (False, True):
            a = getattr(pt, gen)(list(lines), vals, cum, 300, np.random.RandomState(1), pad)
            b = getattr(jt, gen)(list(lines), vals, cum, 300, np.random.RandomState(1), pad)
            assert a == b


def test_trace_and_dist_file_round_trips(tmp_path):
    u, sd, cum = [5, 3, 9], [0, 1, 4], [0.25, 0.5, 1.0]
    pt.write_dist_file(str(tmp_path / "p.log"), u, sd, cum)
    jt.write_dist_file(str(tmp_path / "j.log"), u, sd, cum)
    assert (tmp_path / "p.log").read_bytes() == (tmp_path / "j.log").read_bytes()
    assert pt.read_dist_file(str(tmp_path / "j.log")) == (u, sd, cum)
    for binary in (False, True):
        pt.write_trace_file(str(tmp_path / "pt.log"), [7, 8, 2**40], binary)
        jt.write_trace_file(str(tmp_path / "jt.log"), [7, 8, 2**40], binary)
        assert (tmp_path / "pt.log").read_bytes() == (tmp_path / "jt.log").read_bytes()
        assert pt.read_trace_file(str(tmp_path / "jt.log"), binary) == [7, 8, 2**40]
    shipped = os.path.join(REPO, "input", "dist_emb_0.log")
    assert pt.read_dist_file(shipped) == jt.read_dist_file(shipped)
    shipped = os.path.join(REPO, "input", "trace.log")
    assert pt.read_trace_file(shipped) == jt.read_trace_file(shipped)


def test_trace_main(tmp_path):
    """The distribution generator's CLI: the same dist and synthetic files."""
    trace = str(tmp_path / "trace.log")
    jt.write_trace_file(trace, (np.random.RandomState(2).zipf(1.4, 300) % 40).tolist())
    for pkg, name in ((pt, "p"), (jt, "j")):
        pkg.main(["--trace-file", trace, "--dist-file", str(tmp_path / f"{name}_dist.log"),
                  "--synthetic-file", str(tmp_path / f"{name}_syn.log")])
    for f in ("dist", "syn"):
        assert (tmp_path / f"p_{f}.log").read_bytes() == (tmp_path / f"j_{f}.log").read_bytes()


@pytest.mark.parametrize("lookups,fixed,pad", [(1, False, False), (12, False, False),
                                               (12, True, True), (1, False, True)])
def test_make_trace_batches(lookups, fixed, pad):
    """The shipped dist files (3 of them, wrapped over 5 tables, one table
    smaller than the ids so they wrap by mod)."""
    pattern = os.path.join(REPO, "input", "dist_emb_j.log")
    kw = dict(emb_rows=(1000, 200_000, 50, 70_000, 3000), m_den=13, mini_batch_size=48,
              num_batches=3, num_indices_per_lookup=lookups,
              num_indices_per_lookup_fixed=fixed, seed=4, enable_padding=pad)
    got = pt.make_trace_batches(pattern, **kw)
    _same_batches(got, jt.make_trace_batches(pattern, **kw))
    assert all(int(b.indices[t].max()) < n for b in got for t, n in enumerate(kw["emb_rows"]))
