"""The port's hybrid (whole-table sharded) steps in gloo worlds of 2 and 4
CPU ranks on meshes 2 x 1 (the "data" axis: row grads all-gathered, dense
grads summed) and 2 x 2 (both axes) against the JAX package's
``HybridRunner`` on the same mesh shape (``torch_hybrid_cases``)."""

import pytest

from torch_hybrid_cases import check_world_case, mesh_cases, world_runner


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return world_runner(tmp_path_factory)


@pytest.mark.parametrize("mesh,name", mesh_cases((2, 1), (2, 2)))
def test_hybrid_world_matches_jax(monkeypatch, worlds, mesh, name):
    check_world_case(monkeypatch, worlds(mesh), mesh, name)
