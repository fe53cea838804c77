"""Shared building blocks for the point-cloud models.

Counterparts of ``geometric_adv_tpu/models/layers.py``'s ``PointMLP`` and
``FCStack``. Layout stays ``[b, n, c]`` at every public function: a k=1 conv
over points is an ``nn.Linear`` on the channel axis. Sub-module names follow
the flax ones (``conv_{i}``, ``bn_{i}``, ``fc_{i}``) so the weight bridge
(``models/bridge.py``) maps the trees one to one.

Only inference is ported: batch norm uses its running statistics, which is
also how the attack and eval stages run the victim (frozen stats,
reference: attacker/run_attack.py:88-90). Train mode is ROADMAP Queue 1
item 3.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Inference batch norm over the last (channel) axis, in flax's formula
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` with eps 1e-5."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "batch-norm train mode is not ported yet (ROADMAP Queue 1 "
                "item 3); call .eval()"
            )
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class PointMLP(nn.Module):
    """Per-point Dense -> BN -> ReLU stack (conv1d with filter size 1;
    reference: src/encoders_decoders.py:37-68)."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.n_layers = len(features)
        for i, width in enumerate(features):
            self.add_module(f"conv_{i}", nn.Linear(in_features, width))
            self.add_module(f"bn_{i}", BatchNorm(width))
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
