"""Phase annotations for profiler traces.

``phase_scope`` is the port of ``dlrm_yx_tpu/utils/profiling.py:38-42``:
a ``torch.profiler.record_function`` range with the JAX package's phase
names (``embedding_lookup``, ``bottom_mlp``, ``interaction``, ``top_mlp``),
so traces of the two packages name the same phases. It costs nothing
unless a profiler is recording.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from torch.profiler import record_function


@contextlib.contextmanager
def phase_scope(name: str) -> Iterator[None]:
    with record_function(name):
        yield
