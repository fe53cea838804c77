"""Shared building blocks for the point-cloud models.

Counterparts of ``geometric_adv_tpu/models/layers.py``'s ``PointMLP`` and
``FCStack``. Layout stays ``[b, n, c]`` at every public function: a k=1 conv
over points is an ``nn.Linear`` on the channel axis. Sub-module names follow
the flax ones (``conv_{i}``, ``bn_{i}``, ``fc_{i}``) so the weight bridge
(``models/bridge.py``) maps the trees one to one.

Batch norm follows flax 0.12's ``nn.BatchNorm``: in eval mode it uses its
running statistics, which is how the attack and eval stages run the victim
(frozen stats, reference: attacker/run_attack.py:88-90); in train mode it
normalises with the batch statistics and updates the running ones.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn


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

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
                 bn_momentum: float = 0.9):
        super().__init__()
        self.n_layers = len(features)
        for i, width in enumerate(features):
            self.add_module(f"conv_{i}", nn.Linear(in_features, width))
            self.add_module(f"bn_{i}", BatchNorm(width, momentum=bn_momentum))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x))
        return x


class FCStack(nn.Module):
    """Fully-connected stack, ReLU between layers, the last layer linear
    (reference: src/encoders_decoders.py:86-147, without batch norm, which
    the victim's decoder does not use)."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.n_layers = len(features)
        for i, width in enumerate(features):
            self.add_module(f"fc_{i}", nn.Linear(in_features, width))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"fc_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x
