"""Multi-process start-up and the host-side collectives
(``geometric_adv_tpu/parallel/distributed.py``).

Every process reads the same artifact store and holds the same host
arrays; a pair-parallel stage gives each rank its rows, and
``gather_global`` brings every rank's results back, in rank order, as host
numpy. The collectives move host-bound results and pass barriers, so they
run over gloo on CPU tensors: gloo serves the CPU tests and two ranks that
share one card, where NCCL refuses two ranks on a device.

Training under a mesh sums device tensors over the ranks (the batch norm's
statistics, the gradients): ``all_reduce_sum`` and its differentiable twin
``differentiable_all_reduce_sum``. Their group is chosen once, from the
layout, when the process group forms (``device_backend`` says which and
why): NCCL where every rank has a card of its own, else the gloo group,
whose ``all_reduce`` takes CUDA tensors too. A failure raises; nothing
falls back from one backend to the other.
"""

from __future__ import annotations

import atexit
import os
import socket

import numpy as np
import torch

from geometric_adv_tpu_torch.parallel.mesh import (
    Mesh,
    rank_device,
    shard_batch,
)

BACKEND = "gloo"

# The group that sums device tensors, its backend and the reason for it, as
# ``form_group`` chose them from the layout; None while no group is up.
_DEVICE_GROUP = None


def _up() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _destroy() -> None:
    global _DEVICE_GROUP
    _DEVICE_GROUP = None
    if _up():
        torch.distributed.destroy_process_group()


def backend_for_layout(layout) -> tuple[str, str]:
    """(backend, reason) for device tensors, from each rank's (host, card
    index), the index -1 for a rank on the CPU: NCCL where every rank has a
    card of its own; gloo where two ranks share a card (NCCL refuses them)
    or the ranks run on the CPU."""
    if any(idx < 0 for _, idx in layout):
        return "gloo", "the ranks run on the CPU"
    cards: dict = {}
    for rank, card in enumerate(layout):
        cards.setdefault(tuple(card), []).append(rank)
    for (host, idx), ranks in cards.items():
        if len(ranks) > 1:
            return "gloo", (f"ranks {','.join(map(str, ranks))} share cuda:{idx}"
                            f" on {host}")
    return "nccl", f"each of the {len(layout)} ranks has a card of its own"


def form_group(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the gloo process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``, select the rank's card, and form
    the group that sums device tensors (``device_backend``)."""
    global _DEVICE_GROUP
    torch.distributed.init_process_group(
        BACKEND, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    # a gloo group left up at interpreter exit can abort the process
    atexit.register(_destroy)
    device = rank_device(process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    layout = [None] * num_processes
    torch.distributed.all_gather_object(
        layout, (socket.gethostname(), device.index if device.type == "cuda" else -1))
    backend, reason = backend_for_layout(layout)
    group = (torch.distributed.new_group(backend="nccl") if backend == "nccl"
             else torch.distributed.group.WORLD)
    _DEVICE_GROUP = (group, backend, reason)


def device_backend() -> tuple[str, str] | None:
    """(backend, reason) of the group that sums device tensors, e.g.
    ``("gloo", "ranks 0,1 share cuda:0 on host")``; None while no process
    group is up."""
    return None if _DEVICE_GROUP is None else _DEVICE_GROUP[1:]


def _device_group(mesh: Mesh | None):
    """The group that sums ``mesh``'s device tensors (a group of one too),
    or None where the sum is the identity: no mesh, or a mesh of one
    process outside a group of one. ValueError where the mesh is not the
    process group."""
    if mesh is None:
        return None
    world = torch.distributed.get_world_size() if _up() else 1
    if _up() and mesh.size == world:
        if _DEVICE_GROUP is None:
            raise RuntimeError("the process group was not formed by form_group")
        return _DEVICE_GROUP[0]
    if mesh.size == 1:
        return None
    raise ValueError(f"a mesh of {mesh.size} processes in a process group of {world}")


def all_reduce_sum(tensor: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``tensor`` summed over the mesh's ranks, in place; returns it. The
    identity without a mesh or with one process. Every rank must call it,
    in the same order, with a tensor of the same shape."""
    group = _device_group(mesh)
    if group is not None:
        torch.distributed.all_reduce(tensor, group=group)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x; its backward, dx = sum over the ranks of
    dy, is the same all-reduce: each rank's loss reads every rank's x."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(dx, group=ctx.group)
        return dx, None


def differentiable_all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """A new tensor, ``x`` summed over the mesh's ranks, through which
    gradients flow: its backward sums the incoming gradient over the ranks
    too. The identity without a mesh or with one process."""
    group = _device_group(mesh)
    return x if group is None else _AllReduceSum.apply(x, group)


def _env(name: str) -> str | None:
    return os.environ.get("GAT_" + name) or os.environ.get("JAX_" + name)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the process group at ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``, each missing argument read from
    the ``GAT_``/``JAX_`` variables below; selects the rank's card. Returns
    False, doing nothing, for a count of 1 or when the group is up."""
    if num_processes is None and _env("NUM_PROCESSES"):
        num_processes = int(_env("NUM_PROCESSES"))
    if num_processes is None or num_processes <= 1 or _up():
        return False
    coordinator_address = coordinator_address or _env("COORDINATOR_ADDRESS")
    if process_id is None:
        process_id = int(_env("PROCESS_ID"))
    form_group(coordinator_address, num_processes, process_id)
    return True


def maybe_initialize_from_env() -> bool:
    """Initialise the process group from environment variables.

    Every pipeline CLI routes through this (cli/common.py calls it at
    import), so a stage runs over several processes without code changes:
    launch one process per card with

        GAT_COORDINATOR_ADDRESS=<host0>:<port>
        GAT_NUM_PROCESSES=<n>  GAT_PROCESS_ID=<i>

    (JAX_-prefixed spellings are honoured too). Returns True when the group
    was initialised; no-op (False) when the variables are absent, the
    process count is 1, or the group is already up.
    """
    num = _env("NUM_PROCESSES")
    if num is None or int(num) <= 1 or _up():
        return False
    return initialize_distributed()


def make_global_replicated(array, mesh: Mesh) -> torch.Tensor:
    """A host value every process holds whole, on the rank's device."""
    return torch.as_tensor(np.asarray(array), device=mesh.device)


def shard_host_batch(batch: np.ndarray, mesh: Mesh, axis_name="data") -> torch.Tensor:
    """This rank's rows of a host batch every process holds whole: process
    p owns rows [p*n/P, (p+1)*n/P), on its device."""
    return shard_batch(batch, mesh, axis_name)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gather_global(tree, axis: int = 0):
    """Every rank's leaves, as host numpy, concatenated along ``axis`` in
    rank order; every rank receives the whole arrays (the CLIs' writers
    need them; only the primary writes). One process: the leaves as host
    numpy, with no collective."""
    if not _up() or torch.distributed.get_world_size() == 1:
        return _tree_map(_host, tree)
    world = torch.distributed.get_world_size()

    def gather(x):
        local = torch.from_numpy(np.ascontiguousarray(_host(x)))
        parts = [torch.empty_like(local) for _ in range(world)]
        torch.distributed.all_gather(parts, local)
        return np.concatenate([p.numpy() for p in parts], axis=axis)

    return _tree_map(gather, tree)


def is_primary() -> bool:
    """True on the process that owns artifact and checkpoint writes."""
    return not _up() or torch.distributed.get_rank() == 0


def broadcast_object(obj):
    """The primary's ``obj`` (picklable) on every rank; ``obj`` itself with
    one process."""
    if not _up() or torch.distributed.get_world_size() == 1:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every process (no-op with one): the primary's writes are
    on disk once every rank has passed it."""
    if _up() and torch.distributed.get_world_size() > 1:
        torch.distributed.barrier()


def host_local_batch_to_global(local_batch: np.ndarray, mesh: Mesh,
                               axis_name="data") -> torch.Tensor:
    """This process's shard of a global batch, on its device: the global
    array is every process's shard in rank order along the batch axis
    (``gather_global`` assembles it)."""
    return torch.as_tensor(np.asarray(local_batch), device=mesh.device)

