"""Chamfer / nearest-neighbour distance (the reference's ``nn_distance`` op).

Contract (reference: external/structural_losses/tf_nndistance.py:15-26):

    nn_distance(xyz1[..., n, 3], xyz2[..., m, 3])
        -> (dist1[..., n], idx1[..., n], dist2[..., m], idx2[..., m])

``dist*`` are squared L2 distances to the nearest neighbour in the other
cloud, ``idx*`` the first index attaining it (int32). The gradient is the
reference's scatter-add backward (tf_nndistance.cpp:130-163); the index
outputs carry none.

Each op dispatches on the device of its input, in one place: a CUDA tensor
launches the hand-written kernel of ``ops/cuda/chamfer.py``, a CPU tensor
runs the plain PyTorch version defined here, any other device raises. The
plain versions are also what the kernels are checked against on the card.
"""

from __future__ import annotations

import torch

from geometric_adv_tpu_torch.ops.cuda import chamfer as _cuda


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the ops run on cuda or cpu tensors, got {t.device}")


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., n, m] squared distances, ((dx*dx) + (dy*dy)) + (dz*dz) exactly
    as the CUDA kernels form them (the JAX package's "direct" method)."""
    d = x[..., :, None, :] - y[..., None, :, :]
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def nn_distance_plain(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Plain version of kernel K1 (``nn_distance_cuda``)."""
    sqd = pairwise_sqdist(xyz1, xyz2)
    d1, i1 = sqd.min(dim=-1)  # first index of the minimum on ties
    d2, i2 = sqd.min(dim=-2)
    return d1, i1.to(torch.int32), d2, i2.to(torch.int32)


def nn_distance_values_plain(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Plain version of kernel K2 (``nn_distance_values_cuda``)."""
    sqd = pairwise_sqdist(xyz1, xyz2)
    return sqd.amin(dim=-1), sqd.amin(dim=-2)


def _take_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts[..., idx, :] along the point axis with batched indices."""
    index = idx.long()[..., None].expand(*idx.shape, pts.shape[-1])
    return torch.gather(pts, -2, index)


def chamfer_grad1_plain(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """Plain version of kernel K3 (``chamfer_grad1_cuda``): the reference
    scatter-add formula for the gradient wrt xyz1,
    ``2*g1*(x1 - x2[idx1]) - scatter_add(2*g2*(x2 - x1[idx2]), idx2)``."""
    t1 = 2.0 * g1[..., None] * (xyz1 - _take_points(xyz2, idx1))
    t2 = 2.0 * g2[..., None] * (xyz2 - _take_points(xyz1, idx2))
    index = idx2.long()[..., None].expand(*idx2.shape, 3)
    return t1 - torch.zeros_like(xyz1).scatter_add_(-2, index, t2)


def _flat(t: torch.Tensor, tail: int) -> torch.Tensor:
    """Fold the leading batch dims into one, as the kernels take [b, ...]."""
    return t.reshape((-1,) + tuple(t.shape[t.dim() - tail:])).contiguous()


def _nn_distance_forward(xyz1, xyz2):
    if not _on_cuda(xyz1):
        return nn_distance_plain(xyz1, xyz2)
    lead = xyz1.shape[:-2]
    d1, i1, d2, i2 = _cuda.nn_distance_cuda(_flat(xyz1, 2), _flat(xyz2, 2))
    n, m = xyz1.shape[-2], xyz2.shape[-2]
    return (d1.reshape(lead + (n,)), i1.reshape(lead + (n,)),
            d2.reshape(lead + (m,)), i2.reshape(lead + (m,)))


def chamfer_grad1(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """Gradient wrt xyz1 of ``sum(g1*dist1) + sum(g2*dist2)``."""
    if not _on_cuda(xyz1):
        return chamfer_grad1_plain(xyz1, xyz2, idx1, idx2, g1, g2)
    out = _cuda.chamfer_grad1_cuda(
        _flat(xyz1, 2), _flat(xyz2, 2), _flat(idx1, 1), _flat(idx2, 1),
        _flat(g1, 1), _flat(g2, 1),
    )
    return out.reshape(xyz1.shape)


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, i1, d2, i2 = _nn_distance_forward(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        xyz1, xyz2, i1, i2 = ctx.saved_tensors
        grad1 = grad2 = None
        # only the directions autograd asks for: the attack differentiates
        # wrt its first argument alone, so grad2 is never computed there
        if ctx.needs_input_grad[0]:
            grad1 = chamfer_grad1(xyz1, xyz2, i1, i2, g1, g2)
        if ctx.needs_input_grad[1]:
            grad2 = chamfer_grad1(xyz2, xyz1, i2, i1, g2, g1)
        return grad1, grad2


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Bidirectional NN squared distances + first-index argmins.

    Mirrors reference: external/structural_losses/tf_nndistance.py:15.
    Supports arbitrary leading batch dims.
    """
    return _NNDistance.apply(xyz1, xyz2)


def nn_distance_values(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Bidirectional NN squared distances only, not differentiable: the
    all-pairs chamfer matrix job, which never reads the indices."""
    if not _on_cuda(xyz1):
        return nn_distance_values_plain(xyz1, xyz2)
    lead = xyz1.shape[:-2]
    d1, d2 = _cuda.nn_distance_values_cuda(_flat(xyz1, 2), _flat(xyz2, 2))
    return (d1.reshape(lead + (xyz1.shape[-2],)),
            d2.reshape(lead + (xyz2.shape[-2],)))


def chamfer_loss_per_pc(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-cloud Chamfer distance: mean(d1) + mean(d2) of squared NN dists
    (reference: src/adv_ae.py:118-121, src/pointnet_ae.py:74-76)."""
    d1, _, d2, _ = nn_distance(pred, gt)
    return d1.mean(dim=-1) + d2.mean(dim=-1)


def chamfer_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Scalar Chamfer loss: mean over all points in the batch, both
    directions (reference: src/pointnet_ae.py:74-76)."""
    d1, _, d2, _ = nn_distance(pred, gt)
    return d1.mean() + d2.mean()


def fscore(dist1: torch.Tensor, dist2: torch.Tensor, threshold: float = 0.001):
    """F-score of two clouds from their squared NN distances
    (reference: ChamferDistancePytorch/fscore.py:3-16)."""
    precision_1 = (dist1 < threshold).float().mean(dim=-1)
    precision_2 = (dist2 < threshold).float().mean(dim=-1)
    denom = precision_1 + precision_2
    f = torch.where(
        denom > 0,
        2 * precision_1 * precision_2 / torch.clamp(denom, min=1e-12),
        torch.zeros_like(denom),
    )
    return f, precision_1, precision_2
