"""The frozen yardstick: traffic from the seed, weights from the seed, the
operation and byte counts, and the trace arithmetic, against hand counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import counts
from benchmark.draw import DRAW_BLOCK_ROWS, draw_block, draw_rows, draw_tower, stream_seed
from benchmark.generate import make_batches
from benchmark.trace import gaps, label_gaps, union_length

MIX = {"ids": {"law": "power", "alpha": 1.15},
       "dense": {"law": "poisson_log1p", "mean": 3.0, "features": 13},
       "labels": {"positive_share": 0.25}}
RAW = [39884406, 3, 20263, 585935]
CAP = 100_000
BIG_SEED = 2**31 + 987_654_321


@pytest.mark.parametrize("law", ["power", "uniform"])
def test_batches_repeat_for_a_seed_and_differ_across_seeds(law):
    mix = dict(MIX, ids={"law": law, "alpha": 1.15})
    a = make_batches(mix, RAW, CAP, 256, 3, BIG_SEED)
    b = make_batches(mix, RAW, CAP, 256, 3, BIG_SEED)
    c = make_batches(mix, RAW, CAP, 256, 3, BIG_SEED + 1)
    for x, y in zip(a, b):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))
    assert not np.array_equal(a[0][1], c[0][1]) and not np.array_equal(a[0][0], c[0][0])
    dense, idx, w, labels = a[0]
    assert dense.shape == (256, 13) and dense.dtype == np.float32
    assert idx.shape == (4, 256, 1) and idx.dtype == np.int32 and (w == 1).all()
    assert labels.shape == (256, 1) and set(np.unique(labels)) <= {0.0, 1.0}
    for t, m in enumerate(RAW):
        assert idx[t].min() >= 0 and idx[t].max() < min(m, CAP)
    assert not np.array_equal(a[0][1], a[1][1])  # the pool's batches differ


def test_power_law_is_skewed_and_uniform_is_not():
    n = 20_000
    power = make_batches(MIX, [10**7], 10**6, n, 1, 3)[0][1].reshape(-1)
    uni = make_batches(dict(MIX, ids={"law": "uniform"}), [10**7], 10**6, n, 1, 3)[0][1]
    assert np.unique(power).size < 0.5 * n < np.unique(uni).size
    # rank r has density ~ r^-1.15: id 0 takes far more than its share
    assert (power == 0).mean() > 100 / 10**6


def test_draws_repeat_and_do_not_depend_on_the_rows_asked_for():
    a = draw_block(BIG_SEED, 3, 5000, 8, 0, 5000, "cpu")
    assert torch.equal(a, draw_block(BIG_SEED, 3, 5000, 8, 0, 5000, "cpu"))
    assert not torch.equal(a, draw_block(BIG_SEED, 4, 5000, 8, 0, 5000, "cpu"))
    ids = torch.tensor([4999, 7, 1234, 7])
    assert torch.equal(draw_rows(BIG_SEED, 3, 5000, 8, ids), a[ids])
    bound = float(np.float32(np.sqrt(1 / 5000)))
    assert a.abs().max() <= bound
    rows = DRAW_BLOCK_ROWS + 10
    ids = torch.tensor([DRAW_BLOCK_ROWS + 3, 1])
    got = draw_rows(1, 0, rows, 2, ids)
    assert torch.equal(got[0], draw_block(1, 0, rows, 2, DRAW_BLOCK_ROWS, rows, "cpu")[3])
    assert torch.equal(got[1], draw_block(1, 0, rows, 2, 0, 5, "cpu")[1])
    (w0, b0), (w1, _) = draw_tower(BIG_SEED, 0, [13, 512, 4], "cpu")
    assert w0.shape == (13, 512) and b0.shape == (512,) and w1.shape == (512, 4)
    assert abs(float(w0.std()) - np.sqrt(2 / 525)) < 0.1 * np.sqrt(2 / 525)
    assert stream_seed(2**70, 1) != stream_seed(2**70, 2)


def test_flop_counts_match_hand_counts():
    shape = {"rows": [10, 20], "dim": 4, "ln_bot": [3, 5, 4], "ln_top": [7, 2, 1],
             "compute_dtype": "bfloat16"}
    # bottom 3x5 + 5x4, top 7x2 + 2x1, 3 pairs of width 4
    assert counts.mlp_flops([3, 5, 4]) == 2 * (15 + 20)
    assert counts.interaction_flops(shape) == 2 * 3 * 4
    assert counts.forward_flops(shape) == 70 + 24 + 2 * (14 + 2)
    assert counts.train_flops(shape) == 3 * 126
    assert counts.peak_flop_per_s(shape) == 989e12
    terabyte = {"rows": [1] * 26, "dim": 128, "ln_bot": [13, 512, 256, 128],
                "ln_top": [479, 1024, 1024, 512, 256, 1]}
    assert counts.train_flops(terabyte) == 3 * (340_992 + 89_856 + 4_389_376)


def test_k1_and_k2_byte_counts_match_hand_counts():
    nbytes, flops = counts.k1_forward(b=2, s=2, d=4)  # 3 features, 3 pairs
    assert nbytes == 4 * (2 * 4 + 2 * 2 * 4 + 2 * (4 + 3)) and flops == 2 * 2 * 3 * 4
    shape = {"rows": [100, 5, 100], "dim": 4, "split_threshold": 10}
    # big tables 0 and 2; table 0 ids 1, 1, 2 (a row twice, a row once), table 2 ids 1, 3, 4
    idx = np.array([[1, 1, 2], [0, 0, 0], [1, 3, 4]], np.int32)[:, :, None]
    nbytes, flops = counts.k2_step(idx, shape)
    row = 16
    assert nbytes == 8 * 6 + 2 * row * 4 + row * 2 + 2 * row * 1
    assert flops == 4 * 2
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)


def test_union_of_device_intervals_counts_overlap_once():
    busy, merged = union_length([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)])
    assert busy == pytest.approx(3.0) and merged == [(0.0, 2.0), (3.0, 4.0)]
    assert gaps(merged) == [(2.0, 3.0)]
    host = [(1.5, 3.5, "outer"), (2.4, 2.6, "inner"), (5.0, 6.0, "later")]
    assert label_gaps([(2.0, 3.0)], host) == {"inner": 1.0}
    assert label_gaps([(4.0, 4.5)], host) == {"no host operation": 0.5}
