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

The per-cloud loss has two routes, as in the JAX package: composed
(``nn_distance``: K1 forward, K3 backward) and fused (K5 in the forward,
an elementwise backward from its payloads), chosen by ``method`` and
``FUSED_LOSS_ENABLED``. ``chamfer_frozen_payloads`` serves the attack's
frozen-assignment mode. ``chamfer_grad1_vpu`` (K4) is an op entry of its
own, unrouted as in the JAX package.

``nn_distance`` and ``chamfer_loss_per_pc`` open the span
``chamfer.forward``, and their backwards ``chamfer.backward``
(``utils/profiling.py``); the per-cloud loss does not go through the public
``nn_distance``, so the span never holds itself.
"""

from __future__ import annotations

import torch

from geometric_adv_tpu_torch.ops.cuda import chamfer as _cuda
from geometric_adv_tpu_torch.utils.profiling import span


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the ops run on cuda or cpu tensors, got {t.device}")


def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, as ((t0 + t1) + t2) where it has 3 entries."""
    if t.shape[-1] != 3:
        return t.sum(dim=-1)
    return (t[..., 0] + t[..., 1]) + t[..., 2]


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor,
                    method: str = "direct") -> torch.Tensor:
    """[..., n, m] squared distances between [..., n, c] and [..., m, c].

    "direct": ((dx*dx) + (dy*dy)) + (dz*dz) at c = 3, exactly as the CUDA
    kernels form them. "mxu": |x|^2 + |y|^2 - 2 x.y^T through ``torch.matmul``,
    clamped at 0 (the JAX package's ops/chamfer.py:57-65; full float32
    where TF32 is off, as ``cli.common.resolve_device`` sets)."""
    if method == "direct":
        d = x[..., :, None, :] - y[..., None, :, :]
        return _sum_last(d * d)
    if method == "mxu":
        xy = torch.matmul(x, y.transpose(-1, -2))
        d = _sum_last(x * x)[..., :, None] + _sum_last(y * y)[..., None, :] - 2.0 * xy
        return torch.clamp_min(d, 0.0)
    raise ValueError(f"unknown pairwise_sqdist method: {method!r}")


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


def chamfer_grad1_vpu_plain(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """Plain version of kernel K4 (``chamfer_grad1_vpu_cuda``): K3's gradient
    in the algebra of ``chamfer_grad1_pallas_vpu`` (chamfer_bwd_kernel.py:
    288-294), with w = 2*g2: ``2*g1*(x1 - x2[idx1]) - scatter_add(w*x2,
    idx2) + x1 * scatter_add(w, idx2)``."""
    w = 2.0 * g2
    index = idx2.long()[..., None].expand(*idx2.shape, 3)
    sc = torch.zeros_like(xyz1).scatter_add_(-2, index, xyz2 * w[..., None])
    cnt = torch.zeros_like(g1).scatter_add_(-1, idx2.long(), w)
    gath = _take_points(xyz2, idx1)
    return (2.0 * g1)[..., None] * (xyz1 - gath) - sc + xyz1 * cnt[..., None]


def chamfer_loss_payloads_plain(x1: torch.Tensor, x2: torch.Tensor):
    """Plain version of kernel K5 (``chamfer_loss_payloads_cuda``):
    (d1, i1, d2, i2, nn1, snn1, cnt1) with nn1[i] = x2[i1[i]],
    snn1[i] = sum_{j: i2[j] == i} x2[j], cnt1[i] = #{j: i2[j] == i}."""
    d1, i1, d2, i2 = nn_distance_plain(x1, x2)
    index = i2.long()[..., None].expand(*i2.shape, 3)
    snn1 = torch.zeros_like(x1).scatter_add_(-2, index, x2)
    cnt1 = torch.zeros(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    cnt1.scatter_add_(-1, i2.long(), torch.ones_like(i2, dtype=x1.dtype))
    return d1, i1, d2, i2, _take_points(x2, i1), snn1, cnt1


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


def chamfer_grad1_vpu(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """``chamfer_grad1``'s contract through K4 (the JAX package's
    ``chamfer_grad1_pallas_vpu``); no route of the package calls it."""
    if not _on_cuda(xyz1):
        return chamfer_grad1_vpu_plain(xyz1, xyz2, idx1, idx2, g1, g2)
    out = _cuda.chamfer_grad1_vpu_cuda(
        _flat(xyz1, 2), _flat(xyz2, 2), _flat(idx1, 1), _flat(idx2, 1),
        _flat(g1, 1), _flat(g2, 1),
    )
    return out.reshape(xyz1.shape)


def chamfer_loss_payloads(x1: torch.Tensor, x2: torch.Tensor):
    """K5, or its plain version on the CPU: (d1, i1, d2, i2, nn1, snn1,
    cnt1) for [..., n, 3] and [..., m, 3] clouds."""
    if not _on_cuda(x1):
        return chamfer_loss_payloads_plain(x1, x2)
    lead = x1.shape[:-2]
    n, m = x1.shape[-2], x2.shape[-2]
    outs = _cuda.chamfer_loss_payloads_cuda(_flat(x1, 2), _flat(x2, 2))
    shapes = ((n,), (n,), (m,), (m,), (n, 3), (n, 3), (n,))
    return tuple(t.reshape(lead + s) for t, s in zip(outs, shapes))


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, i1, d2, i2 = _nn_distance_forward(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        with span("chamfer.backward"):
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
    with span("chamfer.forward"):
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


# The fused loss's process-wide switch, the JAX package's tri-state:
# None (default) = auto-routing, fused on the card for n <= 1024 only;
# True = fused wherever the gate allows (n <= 2048), on the CPU too, through
# K5's plain version; False = composed everywhere.
FUSED_LOSS_ENABLED = None


def _fused_loss_shape_ok(n: int) -> bool:
    """The fused loss's shape gate (the JAX kernel takes n <= 2048 after
    padding to 256), independent of FUSED_LOSS_ENABLED so that the attack
    runner's calibration gate does not follow an earlier decision."""
    return max(n, 256) <= 2048


def _fused_loss_supported(n: int) -> bool:
    """Uncalibrated auto-routing: fused for n <= 1024, or wherever the gate
    allows when FUSED_LOSS_ENABLED forces it."""
    if FUSED_LOSS_ENABLED is None:
        return max(n, 256) <= 1024
    return FUSED_LOSS_ENABLED and _fused_loss_shape_ok(n)


class _ChamferPerPcFused(torch.autograd.Function):
    """mean(d1) + mean(d2) per cloud from K5's payloads; the backward wrt
    the first cloud is elementwise, the second goes through K3."""

    @staticmethod
    def forward(ctx, x1, x2):
        d1, i1, d2, i2, nn1, snn1, cnt1 = chamfer_loss_payloads(x1, x2)
        ctx.save_for_backward(x1, x2, i1, i2, nn1, snn1, cnt1)
        return d1.mean(dim=-1) + d2.mean(dim=-1)

    @staticmethod
    def backward(ctx, g):
        with span("chamfer.backward"):
            x1, x2, i1, i2, nn1, snn1, cnt1 = ctx.saved_tensors
            n, m = x1.shape[-2], x2.shape[-2]
            grad1 = grad2 = None
            if ctx.needs_input_grad[0]:
                # the reference formula (tf_nndistance.cpp:130-163) with the
                # per-cloud means' uniform weights folded in
                grad1 = g[..., None, None] * (
                    (2.0 / n) * (x1 - nn1)
                    + (2.0 / m) * (x1 * cnt1[..., None] - snn1)
                )
            if ctx.needs_input_grad[1]:
                g1v = (g[..., None] / n).expand(x1.shape[:-1])
                g2v = (g[..., None] / m).expand(x2.shape[:-1])
                grad2 = chamfer_grad1(x2, x1, i2, i1, g2v, g1v)
            return grad1, grad2


def _takes_fused(pred: torch.Tensor, method: str) -> bool:
    n = pred.shape[-2]
    if method == "fused":
        return _fused_loss_shape_ok(n)
    if method == "composed":
        return False
    if method == "auto":
        return ((_on_cuda(pred) or FUSED_LOSS_ENABLED is True)
                and _fused_loss_supported(n))
    raise ValueError(f"unknown chamfer method {method!r}")


def chamfer_loss_per_pc(pred: torch.Tensor, gt: torch.Tensor,
                        method: str = "auto") -> torch.Tensor:
    """Per-cloud Chamfer distance: mean(d1) + mean(d2) of squared NN dists
    (reference: src/adv_ae.py:118-121, src/pointnet_ae.py:74-76).

    ``method``: "composed" (K1, K3), "fused" (K5 where n <= 2048, else
    composed) or "auto" (fused on the card as ``_fused_loss_supported``
    says, or anywhere when FUSED_LOSS_ENABLED is True; composed otherwise).
    A fused call that autograd will not differentiate takes the values-only
    K2, as the JAX primal does; only a differentiated call runs K5.
    """
    with span("chamfer.forward"):
        if _takes_fused(pred, method):
            if torch.is_grad_enabled() and (pred.requires_grad or gt.requires_grad):
                return _ChamferPerPcFused.apply(pred, gt)
            d1, d2 = nn_distance_values(pred, gt)
        else:
            d1, _, d2, _ = _NNDistance.apply(pred, gt)
        return d1.mean(dim=-1) + d2.mean(dim=-1)


@torch.no_grad()
def chamfer_frozen_payloads(x1: torch.Tensor, x2: torch.Tensor):
    """(d1, d2, nn1, snn1, cnt1): what the frozen-assignment chamfer carries
    between refreshes (the JAX package's ops/chamfer.py:349-416).

    With the assignments frozen where these were computed, the loss and its
    gradient wrt x1 are elementwise in the payloads (attack/core.py::
    _frozen_chamfer_terms, in the difference-correction form). Not
    differentiable. K5 takes any n and m on the card, so every size runs
    it there (the JAX kernel's n <= 2048 gate is a TPU memory limit); the
    CPU runs its plain version.
    """
    d1, _, d2, _, nn1, snn1, cnt1 = chamfer_loss_payloads(x1, x2)
    return d1, d2, nn1, snn1, cnt1


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
