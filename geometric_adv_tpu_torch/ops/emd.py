"""Approximate Earth Mover's Distance (the reference's ``approx_match`` /
``match_cost`` op pair) and the fused EMD loss.

Counterpart of ``geometric_adv_tpu/ops/emd.py``. Contract (reference:
external/structural_losses/tf_approxmatch.py:10-50):

    approx_match(xyz1[b, n, 3], xyz2[b, m, 3]) -> match[b, m, n]  (no gradient)
    match_cost(xyz1, xyz2, match)              -> cost[b]

``approx_match`` runs the 9+1 round auction with ``level = -4**j`` for
j = 7..-1 and 0 on the last round, starting from the integer multipliers
``n // m`` / ``m // n``; ``match_cost`` is ``sum(match * sqrt(d2))`` with the
reference's ``(a - b) / d`` gradient. ``emd_loss_fused`` is the value of
``match_cost(pred, gt, approx_match(pred, gt))`` without storing the match:
one sweep accumulates the cost and, when a gradient is wanted, the gradients
round by round.

The sweep dispatches on the device of its input, in one place
(``emd_sweep``): a CPU tensor runs the plain version ``emd_sweep_plain``; a
CUDA tensor launches kernel K6 (``emd_sweep_block_cuda``) when n and m are at
most 1024 -- the TPU kernel's own gate -- and K7 (``emd_sweep_tiled_cuda``)
otherwise; any other device raises. The routing is a function of shape only.
"""

from __future__ import annotations

import torch

from geometric_adv_tpu_torch.ops.chamfer import _on_cuda
from geometric_adv_tpu_torch.ops.cuda import emd as _cuda

# Temperature schedule: j = 7, 6, ..., -1 with level = -(4^j); final round 0.
_LEVELS = tuple([-(4.0**j) for j in range(7, -3, -1)][:-1] + [0.0])


def sweep_route(n: int, m: int) -> str:
    """Which kernel a CUDA sweep of n x m points launches: "block" (K6)
    within ``emd_fused_kernel.py::fused_sweep_supported``'s gate, else
    "tiled" (K7)."""
    limit = _cuda.BLOCK_MAX_POINTS
    fits = max(n, 128) <= limit and max(m, 128) <= limit
    return "block" if fits else "tiled"


def _sqdist_planes(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """[b, n, 3], [b, m, 3] -> [b, n, m] squared distances,
    ((dx*dx) + (dy*dy)) + (dz*dz), without an [n, m, 3] intermediate."""
    dx = xyz1[:, :, None, 0] - xyz2[:, None, :, 0]
    dy = xyz1[:, :, None, 1] - xyz2[:, None, :, 1]
    dz = xyz1[:, :, None, 2] - xyz2[:, None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[b, n, m] @ [b, m] -> [b, n]."""
    return (a @ v[..., None])[..., 0]


def _vecmat(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """[b, n] @ [b, n, m] -> [b, m]."""
    return (v[:, None, :] @ a)[:, 0]


def auction_kernel(level: float, sqd: torch.Tensor) -> torch.Tensor:
    """K = exp(level * d2), the plane of one auction round."""
    return torch.exp(level * sqd)


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Soft assignment match[b, m, n]; carries no gradient
    (reference: tf_approxmatch.py:10-19)."""
    with torch.no_grad():
        n, m = xyz1.shape[-2], xyz2.shape[-2]
        mult_l, mult_r = _cuda.multipliers(n, m)
        sqd = _sqdist_planes(xyz1, xyz2)
        b = xyz1.shape[0]
        match = torch.zeros_like(sqd)
        remain_l = torch.full((b, n), mult_l, dtype=sqd.dtype, device=sqd.device)
        remain_r = torch.full((b, m), mult_r, dtype=sqd.dtype, device=sqd.device)
        for level in _LEVELS:
            k = torch.exp(level * sqd)
            suml = _matvec(k, remain_r) + 1e-9
            ratio_l = remain_l / suml
            sumr = _vecmat(ratio_l, k) * remain_r
            consumption = torch.clamp(remain_r / (sumr + 1e-9), max=1.0)
            ratio_r = consumption * remain_r
            remain_r = torch.clamp(remain_r - sumr, min=0.0)
            w = k * ratio_l[:, :, None] * ratio_r[:, None, :]
            match = match + w
            remain_l = torch.clamp(remain_l - w.sum(dim=2), min=0.0)
        return match.transpose(-1, -2)


class _MatchCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, match):
        d = torch.sqrt(_sqdist_planes(xyz1, xyz2))
        ctx.save_for_backward(xyz1, xyz2, match)
        return (match.transpose(-1, -2) * d).sum(dim=(-1, -2))

    @staticmethod
    def backward(ctx, g):
        # reference (a - b) / d with d clamped at 1e-20 under rsqrt
        # (tf_approxmatch_g.cu:229-292), expanded as in the JAX package:
        #   grad1 = rowsum(w) * x1 - w @ x2,  grad2 = colsum(w) * x2 - w^T @ x1
        xyz1, xyz2, match = ctx.saved_tensors
        inv_d = torch.rsqrt(torch.clamp(_sqdist_planes(xyz1, xyz2), min=1e-20))
        w = match.transpose(-1, -2) * inv_d
        grad1 = w.sum(dim=-1)[..., None] * xyz1 - w @ xyz2
        grad2 = w.sum(dim=-2)[..., None] * xyz2 - w.transpose(-1, -2) @ xyz1
        gexp = g[:, None, None]
        return grad1 * gexp, grad2 * gexp, None


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor,
               match: torch.Tensor) -> torch.Tensor:
    """EMD transport cost[b] = sum(match[l, k] * ||x1[k] - x2[l]||)
    (reference: tf_approxmatch.py:27-36, approxmatch.cpp:79-99)."""
    return _MatchCost.apply(xyz1, xyz2, match)


def emd_sweep_plain(xyz1: torch.Tensor, xyz2: torch.Tensor,
                    want_g1: bool = True, want_g2: bool = True):
    """Plain version of kernels K6 and K7: ``_emd_sweep_single`` of the JAX
    package over a batch, in its operation order.

    [b, n, 3], [b, m, 3] -> (cost [b], g1 [b, n, 3] or None,
    g2 [b, m, 3] or None). The round-invariant planes (squared distance, its
    root and reciprocal root) are formed once instead of in every round: the
    same values. The planes and the auction state (ratios, remains) keep the
    input's dtype, but every plane contraction accumulates in float64 and
    each state update is evaluated in float64 and rounded once, as the
    kernels do: ``remain - sumr`` cancels when a point is nearly spent and
    its leftover sets the next round's bids, so float32 sums taken in two
    orders gave gradients 5e-3 * max|g| apart at [4, 2048, 2000]
    (``csrc/emd_sweep.cu``)."""
    n, m = xyz1.shape[1], xyz2.shape[1]
    b, dtype = xyz1.shape[0], xyz1.dtype
    acc = torch.float64
    mult_l, mult_r = _cuda.multipliers(n, m)
    sqd = _sqdist_planes(xyz1, xyz2)
    d = torch.sqrt(sqd)
    want = want_g1 or want_g2
    inv_d = torch.rsqrt(torch.clamp(sqd, min=1e-20)) if want else None
    x64, y64 = xyz1.to(acc), xyz2.to(acc)
    cost = torch.zeros((b,), dtype=acc, device=xyz1.device)
    g1 = torch.zeros_like(x64) if want_g1 else None
    g2 = torch.zeros_like(y64) if want_g2 else None
    remain_l = torch.full((b, n), mult_l, dtype=dtype, device=xyz1.device)
    remain_r = torch.full((b, m), mult_r, dtype=dtype, device=xyz1.device)
    for level in _LEVELS:
        k_plane = auction_kernel(level, sqd)
        k = k_plane.to(acc)
        rl, rr = remain_l.to(acc), remain_r.to(acc)
        suml = _matvec(k, rr) + 1e-9
        ratio_l = (rl / suml).to(dtype).to(acc)
        sumr = _vecmat(ratio_l, k) * rr
        ratio_r = (torch.clamp(rr / (sumr + 1e-9), max=1.0) * rr).to(dtype).to(acc)
        remain_r = torch.clamp(rr - sumr, min=0.0).to(dtype)

        kd = (k_plane * d).to(acc)
        cost = cost + (ratio_l[:, None, :] @ _matvec(kd, ratio_r)[..., None])[:, 0, 0]
        if want:
            mm = (k_plane * inv_d).to(acc)
        if want_g1:
            s0 = _matvec(mm, ratio_r)
            s1 = mm @ (ratio_r[..., None] * y64)
            g1 = g1 + ratio_l[..., None] * (x64 * s0[..., None] - s1)
        if want_g2:
            t0 = _vecmat(ratio_l, mm)
            t1 = mm.transpose(-1, -2) @ (ratio_l[..., None] * x64)
            g2 = g2 + ratio_r[..., None] * (y64 * t0[..., None] - t1)

        remain_l = torch.clamp(rl - ratio_l * _matvec(k, ratio_r), min=0.0).to(dtype)
    return (cost.to(dtype), None if g1 is None else g1.to(dtype),
            None if g2 is None else g2.to(dtype))


def emd_sweep(xyz1: torch.Tensor, xyz2: torch.Tensor, want_g1: bool,
              want_g2: bool):
    """The sweep on the device of its input: plain on the CPU, K6 or K7 on
    a card (``sweep_route``). [b, n, 3], [b, m, 3] -> (cost, g1, g2)."""
    if not _on_cuda(xyz1):
        return emd_sweep_plain(xyz1, xyz2, want_g1, want_g2)
    x, y = xyz1.contiguous(), xyz2.contiguous()
    if sweep_route(x.shape[1], y.shape[1]) == "block":
        return _cuda.emd_sweep_block_cuda(x, y, _LEVELS, want_g1, want_g2)
    return _cuda.emd_sweep_tiled_cuda(x, y, _LEVELS, want_g1, want_g2)


class _EMDLossFused(torch.autograd.Function):
    """Forward in grads mode: the sweep's g1 / g2 are the gradients of the
    cost, saved for the backward (``_emd_fused_bwd``)."""

    @staticmethod
    def forward(ctx, pred, gt):
        want_g1, want_g2 = ctx.needs_input_grad
        cost, g1, g2 = emd_sweep(pred, gt, want_g1, want_g2)
        ctx.save_for_backward(g1, g2)
        return cost

    @staticmethod
    def backward(ctx, g):
        g1, g2 = ctx.saved_tensors
        gexp = g[:, None, None]
        return (None if g1 is None else gexp * g1,
                None if g2 is None else gexp * g2)


def emd_loss_fused(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-cloud approximate EMD [...] of pred [..., n, 3] vs gt [..., m, 3]:
    the value of ``match_cost(pred, gt, approx_match(pred, gt))`` without
    storing the match. The sweep computes the gradient of each argument only
    when autograd will ask for it; otherwise it runs value-only, with the
    same cost."""
    lead = pred.shape[:-2]
    x = pred.reshape((-1,) + tuple(pred.shape[-2:]))
    y = gt.reshape((-1,) + tuple(gt.shape[-2:]))
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        cost = _EMDLossFused.apply(x, y)
    else:
        cost = emd_sweep(x, y, False, False)[0]
    return cost.reshape(lead)


def emd_loss_per_pc(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The AE's EMD training loss per cloud, before the batch mean
    (reference: src/pointnet_ae.py:77-79)."""
    return emd_loss_fused(pred, gt)
