"""Mixed-dimension embeddings: per-table dims and a linear up-projection.

The port's own copy of ``dlrm_yx_tpu/ops/md_embedding.py`` (numpy only),
after the reference's ``tricks/md_embedding_bag.py`` (Ginart et al.,
arXiv:1909.11810): ``md_solver`` gives each table a dim by the alpha power
rule on its sorted row counts, optionally rounded to a power of 2; a table
whose dim is below the base dim gets a bias-free linear projection up to
the base dim after its pooled lookup (the reference's ``PrEmbeddingBag``).

The CLI applies the dims to tables with rows > ``--md-threshold`` when
``--md-flag`` is set (the reference's ``dlrm_s_pytorch.py:291-299``).
``md_solver`` gives the JAX package's ints; ``init_md_projection`` draws
its values from the same ``RandomState`` calls.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def alpha_power_rule(
    n: np.ndarray, alpha: float, d0: Optional[float] = None,
    b_budget: Optional[float] = None,
) -> np.ndarray:
    """d_i = lambda * n_i^-alpha, lambda from the baseline dim d0 of the
    smallest table (or a parameter budget B); dims floored at 1. n must be
    ascending."""
    n = n.astype(np.float64)
    if d0 is not None:
        lamb = d0 * (n[0] ** alpha)
    elif b_budget is not None:
        lamb = b_budget / np.sum(n ** (1 - alpha))
    else:
        raise ValueError("Must specify either d0 or b_budget")
    d = lamb * (n ** -alpha)
    d = np.maximum(d, 1.0)
    if d0 is not None:
        d[0] = d0
    return np.round(d).astype(np.int64)


def pow_2_round(dims: np.ndarray) -> np.ndarray:
    return (2 ** np.round(np.log2(dims.astype(np.float64)))).astype(np.int64)


def md_solver(
    n: np.ndarray,
    alpha: float,
    d0: Optional[float] = None,
    b_budget: Optional[float] = None,
    round_dim: bool = True,
    k: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Mixed-dimension assignment: sort the tables by rows (optionally
    divided by their query frequencies ``k``), apply the power rule,
    optionally round to powers of 2, undo the sort."""
    n = np.asarray(n)
    order = np.argsort(n, kind="stable")
    ns = n[order].astype(np.float64)
    if k is not None:
        ns = ns / np.asarray(k)[order]
    d = alpha_power_rule(ns, alpha, d0=d0, b_budget=b_budget)
    if round_dim:
        d = pow_2_round(d)
    out = np.empty_like(d)
    out[order] = d
    return out


def init_md_projection(
    rng: np.random.RandomState, in_dim: int, out_dim: int
) -> np.ndarray:
    """Xavier-uniform [in_dim, out_dim] projection (the reference's
    ``nn.Linear(embedding_dim, base_dim, bias=False)``, applied as
    ``pooled @ W``)."""
    bound = np.sqrt(6.0 / (in_dim + out_dim))
    return rng.uniform(-bound, bound, size=(in_dim, out_dim)).astype(np.float32)
