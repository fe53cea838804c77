"""The data mesh and batch-sharding helpers
(``geometric_adv_tpu/parallel/mesh.py``).

The JAX package's mesh is a 1-D ``jax.sharding.Mesh`` over every device,
axis ``data``. The port's mesh is the ``torch.distributed`` process group,
one process per card: rank r runs on ``cuda:{r % torch.cuda.device_count()}``
(``parallel/distributed.py`` sets it). A pair-parallel job pads each call's
rows to a multiple of the mesh size, each rank computes its contiguous
share, and ``gather_global`` assembles the call in rank order.

A mesh of size 1 (no process group, or a group of one) is the
single-process path: every caller treats it exactly as ``mesh=None``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The process group as a 1-D data mesh: ``size`` processes, this one
    ``rank``, computing on ``device``."""

    size: int
    rank: int
    device: torch.device
    axis_name: str = DATA_AXIS


@dataclass(frozen=True)
class Sharding:
    """A layout of an array's leading axis over the mesh: cut into
    ``parts`` equal contiguous parts, of which this rank holds part
    ``index`` (one part: the whole array)."""

    parts: int
    index: int

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row array."""
        if n % self.parts:
            raise ValueError(f"{n} rows do not split into {self.parts} equal parts")
        w = n // self.parts
        return slice(self.index * w, (self.index + 1) * w)


def rank_device(rank: int) -> torch.device:
    """The card of ``rank`` (one process per card, ranks past the card
    count sharing them round robin), or the CPU where there is no card."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def get_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS) -> Mesh:
    """The 1-D mesh over the process group (size 1 where none is up).

    ``n_devices`` must be None, 1 (a single-process mesh) or the group's
    size: the port adds a card by adding a process."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    size, rank = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    if n_devices == 1:
        size, rank = 1, 0
    elif n_devices is not None and n_devices != size:
        raise ValueError(f"get_mesh({n_devices}): the mesh is the process group "
                         f"of {size}; launch one process per card")
    return Mesh(size, rank, rank_device(rank), axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> Sharding:
    """The leading (batch) axis split over the mesh, process-major: rank p
    holds rows [p*n/P, (p+1)*n/P) (JAX: ``NamedSharding(mesh, P("data"))``)."""
    return Sharding(mesh.size, mesh.rank)


def replicated(mesh: Mesh) -> Sharding:
    """Every rank holds the whole array (JAX: ``NamedSharding(mesh, P())``)."""
    return Sharding(1, 0)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` (repeating the last element) to a multiple.

    Returns (padded, original_length). Sharded batch jobs need the global
    batch divisible by the mesh size; padding with a repeated element keeps
    shapes static and the pad rows are sliced off after the computation.
    """
    n = x.shape[axis]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width, mode="edge"), n


def shard_batch(x, mesh: Mesh, axis_name: str = DATA_AXIS) -> torch.Tensor:
    """This rank's rows of the host array ``x`` on the mesh's device."""
    x = np.asarray(x)
    return torch.as_tensor(x[batch_sharding(mesh).rows(len(x))], device=mesh.device)


def local_rows(x, mesh: Mesh | None, device) -> tuple[torch.Tensor, int]:
    """(this rank's rows of the host batch ``x`` in float32 on ``device``,
    ``len(x)``): ``x`` padded to a multiple of the mesh size, the last row
    repeated, and cut by ``batch_sharding``; without a mesh, all of ``x``."""
    rows, n = pad_to_multiple(np.asarray(x, np.float32), 1 if mesh is None else mesh.size)
    if mesh is not None:
        rows = rows[batch_sharding(mesh).rows(len(rows))]
    return torch.as_tensor(rows, device=device), n
