"""The ("data", "model") mesh as process groups.

The port of ``dlrm_yx_tpu/parallel/mesh.py``. JAX lays a logical mesh over
``jax.devices()`` and XLA routes the collectives. The port runs one process
per device in a ``torch.distributed`` world, and the mesh is the world's
ranks in JAX's device order, ``np.array(devices).reshape(data, model)``:
rank ``r`` sits at ``(d, m) = divmod(r, model)``. Its process groups are
the world, the model group (the ranks that share ``d``: a shard's tables
exchange pooled vectors there) and the data group (the ranks that share
``m``: replicas of one table shard, which gather each other's row
gradients). ``new_group`` is collective, so every rank creates every
subgroup in the same order.

Without an initialized process group the world is this process alone, and
a 1 x 1 mesh's collectives are identities.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from dlrm_yx_tpu_torch.utils.device import resolve_device

# torch 2.13 renames all_gather_into_tensor (which torch 2.11 has) to
# all_gather_single; the same call
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
# and reduce_scatter_tensor to reduce_scatter_single
_reduce_scatter_into = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


def world() -> tuple:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A rank's view of the mesh: ``shape`` ({"data": D, "model": M}),
    its own ``(d, m)``, its ``device`` and its groups (``world_group``,
    ``model_group``, ``data_group``; None without a process group). The
    collective helpers run on the current stream's order: NCCL's work is
    joined to it, so a CUDA graph can capture them."""

    def __init__(self, data: int, model: int, device: torch.device):
        self.shape = {"data": data, "model": model}
        self.rank, self.size = world()
        self.d, self.m = divmod(self.rank, model)
        self.device = device
        self.distributed = dist.is_available() and dist.is_initialized()
        self.world_group = self.model_group = self.data_group = None
        if self.distributed:
            self.world_group = dist.group.WORLD
            for d in range(data):
                g = dist.new_group([d * model + j for j in range(model)])
                if d == self.d:
                    self.model_group = g
            for m in range(model):
                g = dist.new_group([i * model + m for i in range(data)])
                if m == self.m:
                    self.data_group = g

    @property
    def capturable(self) -> bool:
        """Can a CUDA graph capture this mesh's collectives? NCCL's, on the
        card (and a 1 x 1 mesh with no process group has none); gloo's not."""
        if self.device.type != "cuda":
            return False
        return not self.distributed or dist.get_backend(self.world_group) == "nccl"

    def all_to_all_model(self, out: torch.Tensor, inp: torch.Tensor, async_op: bool = False):
        """``all_to_all_single`` over the model group (dim 0 split into M
        equal chunks, chunk j to model rank j; received chunks in source
        order). Returns the work handle with ``async_op``, else None."""
        if not self.distributed:
            out.copy_(inp)
            return None
        return dist.all_to_all_single(out, inp, group=self.model_group, async_op=async_op)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the world, in place."""
        if self.distributed:
            dist.all_reduce(t, group=self.world_group)
        return t

    def all_reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the model group, in place (JAX's ``psum`` over "model")."""
        if self.distributed and self.shape["model"] > 1:
            dist.all_reduce(t, group=self.model_group)
        return t

    def reduce_scatter_model(self, inp: torch.Tensor) -> torch.Tensor:
        """``inp`` [M, ...] summed over the model group, chunk j of the sum
        to model rank j: this rank's chunk [...]."""
        if self.shape["model"] == 1:
            return inp[0]
        out = torch.empty(inp.shape[1:], dtype=inp.dtype, device=inp.device)
        _reduce_scatter_into(out, inp.reshape((-1,) + tuple(inp.shape[2:])),
                             group=self.model_group)
        return out

    def _all_gather(self, t: torch.Tensor, group, n: int) -> torch.Tensor:
        if not self.distributed:
            return t
        t = t.contiguous()
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _all_gather_into(out, t, group=group)
        return out

    def all_gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's tensors concatenated on dim 0 in data order
        (JAX's tiled ``all_gather`` over "data")."""
        return self._all_gather(t, self.data_group, self.shape["data"])

    def all_gather_model(self, t: torch.Tensor) -> torch.Tensor:
        """The model group's tensors concatenated on dim 0 in model order."""
        return self._all_gather(t, self.model_group, self.shape["model"])

    def all_gather_world(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's tensor concatenated on dim 0 in rank order."""
        return self._all_gather(t, self.world_group, self.size)


def make_mesh(data: int = 1, model: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """Build the ("data", "model") mesh over the world's ranks; ``model=None``
    takes the world size over ``data``. Every rank of the world must be on
    the mesh: a rank is a device, and a rank off the mesh would have no
    part of the step."""
    _, n = world()
    if model is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        model = n // data
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than the {n} devices present")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} leaves ranks of the {n}-rank world off the "
                         "mesh: one rank a device, every rank on the mesh")
    return Mesh(data, model, resolve_device(device))



def batch_split(mesh: Mesh, bsz: int):
    """(rows a data shard looks up, rows a rank's towers take, the first of
    this rank's tower rows) of a global batch of ``bsz``; raises as the JAX
    package does when the mesh does not divide it."""
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    if bsz % (n_data * n_model) or (bsz // n_data) % n_model:
        raise ValueError(
            f"batch size {bsz} incompatible with mesh {dict(mesh.shape)} (needs B % "
            f"(data*model) == 0 and (B/data) % model == 0)")
    bd = bsz // n_data
    bl = bd // n_model
    return bd, bl, (mesh.d * n_model + mesh.m) * bl
