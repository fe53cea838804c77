"""Shared building blocks for the point-cloud models.

Counterparts of ``geometric_adv_tpu/models/layers.py``'s ``PointMLP``,
``ConvUpsampleDecoder`` and ``FCStack``. Layout stays ``[b, n, c]`` at every
public function: a k=1 conv over points is a ``Dense`` (an ``nn.Linear``) on
the channel axis. Sub-module names follow the flax ones (``conv_{i}``,
``bn_{i}``, ``fc_{i}``) so the weight bridge (``models/bridge.py``) maps the
trees one to one.

``dtype`` is flax's compute dtype: parameters and BN statistics stay
float32; a bfloat16 ``Dense`` casts its input, kernel and bias to bfloat16,
rounds the product to bfloat16 and adds the bias in bfloat16, and a
bfloat16 ``BatchNorm`` normalises in float32 and rounds its output to
bfloat16 (flax 0.12's ``Dense`` and ``_normalize``, statistics reduced in
float32 as its ``force_float32_reductions``). At float32 both are the plain
float32 layers.

Batch norm follows flax 0.12's ``nn.BatchNorm``: in eval mode it uses its
running statistics, which is how the attack and eval stages run the victim
(frozen stats, reference: attacker/run_attack.py:88-90); in train mode it
normalises with the batch statistics and updates the running ones.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name ("float32", "bfloat16";
    None is float32); ValueError on any other."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if (dtype or "float32") not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[dtype or "float32"]


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """Batch norm over the last (channel) axis in flax's formula
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` with eps 1e-5.

    Train mode takes the statistics over every axis but the channel axis,
    with flax's fast variance ``mean(x^2) - mean(x)^2`` clipped at 0 (the
    biased variance); gradients flow through both. It then updates the
    running statistics as ``momentum * running + (1 - momentum) * batch``
    (flax's ``momentum``, the reference's ``b_norm_decay``), the biased
    variance included: ``torch.nn.functional.batch_norm`` would weight the
    other way and store the unbiased variance.
    """

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype != torch.float32:
            return self._forward_f32(x.float()).to(self.dtype)
        return self._forward_f32(x)

    def _forward_f32(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                keep = self.momentum
                self.running_mean.copy_(keep * self.running_mean + (1 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1 - keep) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class PointMLP(nn.Module):
    """Per-point Dense -> BN -> ReLU stack (conv1d with filter size 1;
    reference: src/encoders_decoders.py:37-68)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 bn_momentum: float = 0.9, dtype=torch.float32):
        super().__init__()
        self.n_layers = len(features)
        for i, width in enumerate(features):
            self.add_module(f"conv_{i}", Dense(in_features, width, dtype))
            self.add_module(f"bn_{i}", BatchNorm(width, momentum=bn_momentum,
                                                 dtype=dtype))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x))
        return x


class ConvUpsampleDecoder(nn.Module):
    """Per-point conv decoder with tile upsampling (reference:
    src/encoders_decoders.py:150-196): Dense -> [BN] -> ReLU per layer, the
    last layer linear with an optional finishing BN, and after layer i,
    where ``upsample_sizes[i]`` is set, the point axis tiled that many times
    (``jnp.tile``: the whole [n, c] block repeated, not each point)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 upsample_sizes: Sequence[int | None] | None = None,
                 use_bn: bool = True, bn_finish: bool = False,
                 bn_momentum: float = 0.9, dtype=torch.float32):
        super().__init__()
        self.n_layers = len(features)
        self.upsample_sizes = (None if upsample_sizes is None
                               else tuple(upsample_sizes))
        self.has_bn = []
        for i, width in enumerate(features):
            last = i == self.n_layers - 1
            self.add_module(f"conv_{i}", Dense(in_features, width, dtype))
            bn = (use_bn and not last) or (last and bn_finish)
            if bn:
                self.add_module(f"bn_{i}", BatchNorm(width, momentum=bn_momentum,
                                                     dtype=dtype))
            self.has_bn.append(bn)
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            if self.has_bn[i]:
                x = getattr(self, f"bn_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
            if self.upsample_sizes is not None and self.upsample_sizes[i]:
                reps = self.upsample_sizes[i]
                x = x.repeat((1,) * (x.dim() - 2) + (reps, 1))
        return x


class FCStack(nn.Module):
    """Fully-connected stack, ReLU between layers, the last layer linear
    (reference: src/encoders_decoders.py:86-147, without batch norm, which
    the victim's decoder does not use)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.n_layers = len(features)
        for i, width in enumerate(features):
            self.add_module(f"fc_{i}", Dense(in_features, width, dtype))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"fc_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x
