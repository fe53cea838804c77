"""Train-mode batch norm followed by ReLU as one op: ``bn_relu_train``.

The function is ``relu(BatchNorm(x))`` in train mode as
``models/layers.py::BatchNorm`` states it (flax's formula): over every
axis but the last (channel) axis, mean = sum(x)/N, s = sum(x*x)/N, the
biased fast variance v = max(s - mean^2, 0), a = rsqrt(v + eps) * weight
and y = relu((x - mean) * a + bias); the running statistics are updated in
place as ``momentum * running + (1 - momentum) * batch``. Its gradient is
the closed form of that function, the clip included (it flows where
s - mean^2 >= 0, torch.clamp's convention): with g = dy where the
pre-activation is > 0, Sg = sum(g), Sgx = sum(g * (x - mean)),

    dbias = Sg, dweight = r * Sgx (r = rsqrt(v + eps)),
    dv = -r^3/2 * weight * Sgx, dx = g*a + ((x - mean) * 2 dv - a * Sg) / N.

The batch moments, mean(x) and mean(x*x), are taken as BatchNorm takes
them (``batch_moments``: ATen's column means over the input's own shape),
so that the forward and the running statistics are the composed
version's bit for bit: a training step's max-pool argmaxes, ReLU masks and
Adam's near-zero entries part from the composed version's at a changed
last bit of a mean. The rest dispatches on the device of the input: a
CUDA tensor launches the fused kernels of ``ops/cuda/bn_relu.py`` (one
launch forward, two backward), a CPU tensor runs the plain PyTorch version
defined here, which is also what the kernels are checked against on the
card. Which layers take the op, and which keep the composed
``torch.relu(bn(x))``, is decided in ``models/layers.py::takes_fused_bn_relu``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from geometric_adv_tpu_torch.ops.cuda import bn_relu as _cuda


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean(x), mean(x*x)) over every axis but the last, as
    ``BatchNorm`` takes them: three ATen launches (x*x and two means)."""
    axes = tuple(range(x.dim() - 1))
    return x.mean(dim=axes), (x * x).mean(dim=axes)


def bn_relu_forward_plain(x: torch.Tensor, mean: torch.Tensor, mean_sq: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """Plain version of the forward kernel on ``x`` [R, C] and its batch
    moments: (y [R, C], stats [5, C]: mean, v, r, a and flag = (mean_sq -
    mean^2 >= 0) as 1 or 0)."""
    d = mean_sq - mean * mean
    var = torch.clamp(d, min=0.0)
    r = torch.rsqrt(var + eps)
    a = r * weight
    y = torch.relu((x - mean) * a + bias)
    return y, torch.stack([mean, var, r, a, (d >= 0).to(x.dtype)])


def bn_relu_backward_plain(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, stats: torch.Tensor):
    """Plain version of the backward kernels: (dx [R, C], dweight [C],
    dbias [C]) from the forward's x and stats, the closed form above (its
    two column sums, Sg and Sgx)."""
    mean, _var, r, a, flag = stats
    xc = x - mean
    g = torch.where(xc * a + bias > 0, dy, torch.zeros_like(dy))
    sg, sgx = g.sum(dim=0), (g * xc).sum(dim=0)
    dv = torch.where(flag != 0, -0.5 * r * r * r * weight * sgx, torch.zeros_like(sgx))
    dx = g * a + (xc * (2 * dv) - a * sg) / x.shape[0]
    return dx, r * sgx, sg


def update_running(running: torch.Tensor, batch: torch.Tensor, momentum: float) -> None:
    """``running`` set to ``momentum * running + (1 - momentum) * batch``,
    in place (the fused forward kernel forms the same two products and sum)."""
    running.copy_(momentum * running + (1 - momentum) * batch)


class _BNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum):
        mean, mean_sq = batch_moments(x)
        x2 = x.reshape(-1, x.shape[-1])
        if x.device.type == "cuda":
            y, stats = _cuda.bn_relu_forward_cuda(x2, mean, mean_sq, weight, bias,
                                                  running_mean, running_var, eps, momentum)
        else:
            y, stats = bn_relu_forward_plain(x2, mean, mean_sq, weight, bias, eps)
            update_running(running_mean, stats[0], momentum)
            update_running(running_var, stats[1], momentum)
        ctx.save_for_backward(x2, weight, bias, stats)
        return y.view(x.shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x2, weight, bias, stats = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).contiguous()
        if dy.device.type == "cuda":
            dx, dweight, dbias = _cuda.bn_relu_backward_cuda(dy2, x2, weight, bias, stats)
        else:
            dx, dweight, dbias = bn_relu_backward_plain(dy2, x2, weight, bias, stats)
        return dx.view(dy.shape), dweight, dbias, None, None, None, None


def bn_relu_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor,
                  eps: float, momentum: float) -> torch.Tensor:
    """relu(train-mode batch norm of ``x`` [..., C]), the running statistics
    updated in place; differentiable in ``x``, ``weight`` and ``bias``."""
    return _BNReLU.apply(x, weight, bias, running_mean, running_var, eps, momentum)
