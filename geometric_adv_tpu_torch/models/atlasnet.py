"""AtlasNet transfer autoencoder.

Counterpart of ``geometric_adv_tpu/models/atlasnet.py`` (reference:
transfer/atlasnet/model/model_blocks.py:28-105, model/atlasnet.py:18-69):

- encoder: per-point Dense 64-128-nlatent (BN; the last BN without ReLU) ->
  max over points -> two Dense nlatent with BN + ReLU;
- decoder: ``nb_primitives`` patch MLPs (``Mapping2Dto3D``): the template
  point (dim 3 SPHERE, 2 SQUARE) lifted to the bottleneck width with the
  latent **added as a bias after the first Dense**, before its BN, then BN +
  ReLU Dense layers [hidden] x (1 + num_layers) -> 3; the patches'
  outputs concatenated;
- default: 2500 points, 1 SPHERE primitive, bottleneck 1024, hidden 512,
  2 extra hidden layers; BN eps 1e-5, momentum 0.9 (PARITY #1).

The regular templates are numpy (a Fibonacci sphere, a square grid, as the
JAX package's); the train-time random template is drawn from an explicit
``torch.Generator``. Sub-module names follow the flax ones (``encoder.conv1``,
``decoder_0.conv_list0``) for ``models/bridge.py``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from geometric_adv_tpu_torch.models.layers import BatchNorm


def sphere_template_points(n: int) -> np.ndarray:
    """Deterministic near-uniform points on the unit sphere (Fibonacci)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
         np.cos(phi)], axis=1,
    ).astype(np.float32)


def square_template_points(n: int) -> np.ndarray:
    """Regular grid in the unit square (reference: template.py:91-117)."""
    grain = int(np.sqrt(n))
    xs = np.linspace(0, 1, grain)
    g = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    return g.astype(np.float32)[:n]


def random_template_points(generator: torch.Generator, nb_primitives: int,
                           n: int, dim: int, device) -> torch.Tensor:
    """Train-time template: uniform in the unit square, or uniform on the
    unit sphere (normalised gaussians) (reference: template.py:37-44, 66-73)."""
    if dim == 2:
        return torch.rand((nb_primitives, n, 2), generator=generator, device=device)
    v = torch.randn((nb_primitives, n, 3), generator=generator, device=device)
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


class AtlasNetEncoder(nn.Module):
    """reference: model_blocks.py:28-60."""

    def __init__(self, nlatent: int = 1024, bn_momentum: float = 0.9):
        super().__init__()
        for i, (fan_in, width) in enumerate(((3, 64), (64, 128), (128, nlatent))):
            self.add_module(f"conv{i + 1}", nn.Linear(fan_in, width))
            self.add_module(f"bn{i + 1}", BatchNorm(width, momentum=bn_momentum))
        for i in range(2):
            self.add_module(f"lin{i + 1}", nn.Linear(nlatent, nlatent))
            self.add_module(f"bn{i + 4}", BatchNorm(nlatent, momentum=bn_momentum))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = self.bn3(self.conv3(x))  # no relu
        x = x.amax(dim=-2)
        x = torch.relu(self.bn4(self.lin1(x)))
        return torch.relu(self.bn5(self.lin2(x)))


class Mapping2Dto3D(nn.Module):
    """One patch decoder (reference: model_blocks.py:63-105)."""

    def __init__(self, template_dim: int, bottleneck_size: int = 1024,
                 hidden_neurons: int = 512, num_layers: int = 2,
                 bn_momentum: float = 0.9):
        super().__init__()
        self.num_layers = num_layers
        self.conv1 = nn.Linear(template_dim, bottleneck_size)
        self.bn1 = BatchNorm(bottleneck_size, momentum=bn_momentum)
        self.conv2 = nn.Linear(bottleneck_size, hidden_neurons)
        self.bn2 = BatchNorm(hidden_neurons, momentum=bn_momentum)
        for i in range(num_layers):
            self.add_module(f"conv_list{i}", nn.Linear(hidden_neurons, hidden_neurons))
            self.add_module(f"bn_list{i}", BatchNorm(hidden_neurons, momentum=bn_momentum))
        self.last_conv = nn.Linear(hidden_neurons, 3)

    def forward(self, template_pts: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        """template_pts [P, dim], latent [b, bottleneck] -> [b, P, 3]."""
        # the latent added as a bias after the first Dense (model_blocks.py:103)
        h = self.conv1(template_pts) + latent[..., None, :]
        h = torch.relu(self.bn1(h))
        h = torch.relu(self.bn2(self.conv2(h)))
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"bn_list{i}")(getattr(self, f"conv_list{i}")(h)))
        return self.last_conv(h)


class AtlasNet(nn.Module):
    """Full AtlasNet AE (reference: model/model.py:10, model/atlasnet.py:18)."""

    def __init__(self, number_points: int = 2500, nb_primitives: int = 1,
                 template_type: str = "SPHERE", bottleneck_size: int = 1024,
                 hidden_neurons: int = 512, num_layers: int = 2,
                 bn_momentum: float = 0.9):
        super().__init__()
        if template_type not in ("SPHERE", "SQUARE"):
            raise ValueError(f"unknown template_type {template_type!r}")
        self.number_points = number_points
        self.nb_primitives = nb_primitives
        self.template_type = template_type
        self.encoder = AtlasNetEncoder(bottleneck_size, bn_momentum)
        for i in range(nb_primitives):
            self.add_module(f"decoder_{i}", Mapping2Dto3D(
                self.template_dim, bottleneck_size, hidden_neurons, num_layers,
                bn_momentum))

    @property
    def template_dim(self) -> int:
        return 3 if self.template_type == "SPHERE" else 2

    @property
    def pts_per_primitive(self) -> int:
        return self.number_points // self.nb_primitives

    def regular_template(self) -> np.ndarray:
        fn = (sphere_template_points if self.template_type == "SPHERE"
              else square_template_points)
        return fn(self.pts_per_primitive)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[b, n, 3] -> latent [b, bottleneck]."""
        return self.encoder(x)

    def decode(self, latent: torch.Tensor, template_pts: torch.Tensor) -> torch.Tensor:
        """template_pts [nb_primitives, P, dim] -> [b, nb_primitives * P, 3]."""
        return torch.cat([getattr(self, f"decoder_{i}")(template_pts[i], latent)
                          for i in range(self.nb_primitives)], dim=-2)

    def forward(self, x: torch.Tensor, template_pts: torch.Tensor | None = None):
        """-> (recon [b, nb_primitives * P, 3], latent [b, bottleneck]); the
        regular template where ``template_pts`` is None."""
        if template_pts is None:
            tpl = torch.as_tensor(self.regular_template(), device=x.device)
            template_pts = tpl.expand((self.nb_primitives,) + tuple(tpl.shape))
        latent = self.encode(x)
        return self.decode(latent, template_pts), latent
