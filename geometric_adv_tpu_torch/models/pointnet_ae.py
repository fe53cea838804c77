"""PointNet autoencoder — the victim model.

Counterpart of ``geometric_adv_tpu/models/pointnet_ae.py`` (reference:
src/ae_templates.py:11-39, src/pointnet_ae.py:29-48):

- encoder: per-point MLP [64, 128, 128, 256, bneck] with BN+ReLU after every
  layer, then max over the point axis -> z[b, bneck];
- decoder: FC [256, 256, n_points*3], ReLU between, last layer linear, no
  BN, reshaped to [b, n_points, 3] (optionally through tanh).

``dtype`` ("float32" or "bfloat16") is flax's compute dtype
(``models/layers.py``): float32 parameters, the layers computing in
``dtype``, so the outputs are of ``dtype``.

The port's own initialisation draws from an explicit ``torch.Generator``
(``init_weights``). It cannot reproduce flax's init from the same seed; a
victim that must match the JAX package is bridged from its weights
(``models/bridge.py``).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

from geometric_adv_tpu_torch.models.layers import FCStack, PointMLP, compute_dtype

# reference: src/ae_templates.py:22-33
DEFAULT_ENCODER_FILTERS = (64, 128, 128, 256, 128)
DEFAULT_DECODER_SIZES = (256, 256)


class PointNetAE(nn.Module):
    """Victim autoencoder: n_points -> bneck_size -> n_points."""

    def __init__(
        self,
        n_points: int = 2048,
        bneck_size: int = 128,
        encoder_filters: Sequence[int] | None = None,
        decoder_sizes: Sequence[int] | None = None,
        close_with_tanh: bool = False,
        bn_momentum: float = 0.9,
        dtype=torch.float32,
    ):
        super().__init__()
        filters = (
            tuple(encoder_filters)
            if encoder_filters is not None
            else DEFAULT_ENCODER_FILTERS[:-1] + (bneck_size,)
        )
        sizes = (
            tuple(decoder_sizes)
            if decoder_sizes is not None
            else DEFAULT_DECODER_SIZES
        ) + (n_points * 3,)
        self.n_points = n_points
        self.close_with_tanh = close_with_tanh
        self.dtype = compute_dtype(dtype)
        self.encoder = PointMLP(3, filters, bn_momentum, self.dtype)
        self.decoder = FCStack(filters[-1], sizes, self.dtype)

    def forward(self, x: torch.Tensor):
        """[b, n, 3] -> (recon [b, n_points, 3], z [b, bneck],
        pre_symmetry [b, n, bneck])."""
        pre_symmetry = self.encoder(x)
        z = pre_symmetry.amax(dim=-2)  # even gradient split on ties, as jnp.max
        return self.decode(z), z, pre_symmetry

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Latent codes only (reference: src/autoencoder.py:174-176)."""
        return self.encoder(x).amax(dim=-2)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Decode latent codes (reference: src/autoencoder.py:191-194)."""
        out = self.decoder(z)
        if self.close_with_tanh:
            out = torch.tanh(out)
        return out.reshape(out.shape[:-1] + (self.n_points, 3))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init in flax's defaults: Dense weights lecun-normal
    (truncated at 2 sigma), biases zero; batch norm scale 1, shift 0,
    running mean 0 and variance 1. Draws on the CPU, in module order."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            fan_in = module.weight.shape[1]
            # std of the truncated draw is 1/sqrt(fan_in), as flax's
            # variance_scaling(1, fan_in, truncated_normal)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                module.weight.copy_(w)
                module.bias.zero_()
    return model
