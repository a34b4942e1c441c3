"""The port's small single-device helpers against the JAX package's on the
same numpy inputs: ``data.batch.padded_to_csr``, the HDF5 batch files of
``data.synthetic``, ``EventLogger``'s file output and submission block,
and ``StepTimer``'s start / stop / total; and the shape of the port's step
machinery, read from its source."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

from dlrm_yx_tpu.data import synthetic as jax_synthetic
from dlrm_yx_tpu.data.batch import Batch as JaxBatch
from dlrm_yx_tpu.data.batch import padded_to_csr as jax_padded_to_csr
from dlrm_yx_tpu.utils.logging import EventLogger as JaxEventLogger
from dlrm_yx_tpu.utils.profiling import StepTimer as JaxStepTimer
from dlrm_yx_tpu_torch.data import synthetic
from dlrm_yx_tpu_torch.data.batch import csr_to_padded, padded_to_csr
from dlrm_yx_tpu_torch.utils.logging import EventLogger
from dlrm_yx_tpu_torch.utils.profiling import StepTimer


def _batches(n=3, seed=4):
    return synthetic.make_random_batches(synthetic.RandomDataConfig(
        emb_rows=(30, 50, 70), m_den=4, mini_batch_size=8, num_batches=n,
        num_indices_per_lookup=4, num_indices_per_lookup_fixed=False, seed=seed))


def test_padded_to_csr_matches_jax_and_inverts_csr_to_padded():
    b = _batches(1)[0]
    got = padded_to_csr(b.indices, b.weights)
    want = jax_padded_to_csr(np.asarray(b.indices), np.asarray(b.weights))
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype == np.int64
            np.testing.assert_array_equal(x, y)
    idx, w = csr_to_padded(*got, b.indices.shape[1], b.indices.shape[2])
    live = b.weights > 0
    # the live ids come back in front, in order, with weight 1
    for t in range(idx.shape[0]):
        for i in range(idx.shape[1]):
            n = int(live[t, i].sum())
            np.testing.assert_array_equal(idx[t, i, :n], b.indices[t, i][live[t, i]])
            assert (w[t, i, :n] == 1).all() and (w[t, i, n:] == 0).all()


def test_hdf5_batches_cross_load_with_jax(tmp_path):
    pytest.importorskip("h5py")
    bs = _batches()
    synthetic.save_batches_hdf5(str(tmp_path / "port.h5"), bs)
    jax_synthetic.save_batches_hdf5(str(tmp_path / "jax.h5"),
                                    [JaxBatch(*map(np.asarray, b)) for b in bs])
    for path in ("port.h5", "jax.h5"):
        for load in (synthetic.load_batches_hdf5, jax_synthetic.load_batches_hdf5):
            back = load(str(tmp_path / path))
            assert len(back) == len(bs)
            for got, want in zip(back, bs):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
                    assert np.asarray(g).dtype == np.asarray(w).dtype


def _records(path):
    with open(path) as f:
        recs = [json.loads(line[len(":::MLLOG "):]) for line in f]
    for r in recs:
        r.pop("time_ms")
    return recs


def test_event_logger_file_and_submission_block_match_jax(tmp_path, capsys):
    """The same events give the same ``:::MLLOG`` lines in the file (the
    clock aside) and, with ``stdout``, on stdout; ``submission_block``
    logs JAX's five keys."""
    for name, cls in (("port", EventLogger), ("jax", JaxEventLogger)):
        ev = cls(path=str(tmp_path / f"{name}.log"), stdout=name == "port")
        ev.log_start("run_start", {"k": 1})
        ev.log_event("eval_accuracy", 0.5)
        ev.log_end("run_stop")
        ev.submission_block(platform="gpu-h100", org="dlrm")
    assert _records(tmp_path / "port.log") == _records(tmp_path / "jax.log")
    assert len(_records(tmp_path / "port.log")) == 8
    printed = [line for line in capsys.readouterr().out.splitlines() if line.startswith(":::")]
    with open(tmp_path / "port.log") as f:
        assert printed == f.read().splitlines()


def test_step_timer_total_matches_jax():
    port, jax_timer = StepTimer(warmup_iters=1), JaxStepTimer(warmup_iters=1)
    for t in (port, jax_timer):
        t.times.extend([0.5, 0.25, 0.125])
    assert port.total_s() == jax_timer.total_s() == 0.875
    assert port.mean_ms() == jax_timer.mean_ms()
    port.start()
    dt = port.stop()
    assert dt >= 0 and port.times[-1] == dt and port.total_s() == 0.875 + dt


PORT = Path(__file__).resolve().parents[1] / "dlrm_yx_tpu_torch"


def _tree(rel: str) -> ast.AST:
    return ast.parse((PORT / rel).read_text())


def _imports(rel: str) -> set:
    """Every module a port file imports, at any depth of its code
    (``from a import b`` counts as ``a`` and ``a.b``)."""
    out = set()
    for node in ast.walk(_tree(rel)):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def _named(node, name: str) -> bool:
    return (isinstance(node, ast.Name) and node.id == name) or (
        isinstance(node, ast.Attribute) and node.attr == name)


def _graph_steps_built_outside_capture():
    files = [str(p.relative_to(PORT)) for p in sorted(PORT.rglob("*.py"))]
    return [f for f in files if f != "train/capture.py" and any(
        isinstance(n, ast.Call) and _named(n.func, "GraphStep") for n in ast.walk(_tree(f)))]


def _row_family_imports_from_hybrid():
    return [f for f in ("parallel/row_sharded.py", "parallel/col_sharded.py")
            if "dlrm_yx_tpu_torch.parallel.hybrid" in _imports(f)]


def _lower_modules_import_upward():
    return [(f, m) for f in ("train/capture.py", "models/dlrm.py") for m in sorted(_imports(f))
            if m.startswith(("dlrm_yx_tpu_torch.parallel", "dlrm_yx_tpu_torch.train.trainer"))]


def _branches_on_a_missing_runner():
    return [f for f in ("train/trainer.py", "cli.py") for n in ast.walk(_tree(f))
            if isinstance(n, ast.Compare) and isinstance(n.ops[0], (ast.Is, ast.IsNot))
            and any(_named(x, "runner") for x in (n.left, *n.comparators))
            and any(isinstance(x, ast.Constant) and x.value is None
                    for x in (n.left, *n.comparators))]


@pytest.mark.parametrize("offenders", [
    _graph_steps_built_outside_capture,
    _row_family_imports_from_hybrid,
    _lower_modules_import_upward,
    _branches_on_a_missing_runner,
], ids=lambda f: f.__name__.strip("_"))
def test_the_step_machinery_keeps_its_shape(offenders):
    """Every step is built from a body in ``train/capture.py``; the row and
    column modes reach the runner base, not the hybrid mode; the capture
    and model modules sit below the runners; the Trainer and the CLI always
    drive a runner."""
    assert offenders() == []
