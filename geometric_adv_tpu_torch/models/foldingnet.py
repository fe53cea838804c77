"""FoldingNet transfer autoencoder.

Counterpart of ``geometric_adv_tpu/models/foldingnet.py`` (reference:
transfer/foldingnet/foldingnet.py:57-189, prepare_graph.py:45-114):

- graph features: per point, its 16 nearest neighbours (``knn_point`` with
  k = 17, column 0, the point itself under the packed-key tie rule,
  dropped) and their 3x3 covariance (divided by k - 1), flattened to 9;
- encoder: [xyz | cov9] (12) -> Dense 64-64-64 (BN + ReLU) -> graph max-pool
  -> ReLU -> Dense 128 -> BN + ReLU -> graph max-pool -> ReLU -> Dense 1024
  -> BN -> max over points -> Dense 512 (BN + ReLU) -> Dense 512 -> code;
- graph max-pool: max over each point's neighbours, then the elementwise
  max with the point itself (reference: foldingnet.py:33-54);
- decoder: two folds of a 45 x 45 grid in [-0.3, 0.3]^2 conditioned on the
  code: [code | grid] 514 -> 512 -> 512 -> 3, then [code | fold1] 515 ->
  512 -> 512 -> 3, so 2025 points.

The kNN and gathers are the port's ``ops/grouping.py`` (PyTorch, as the JAX
package's are XLA). Sub-module names follow the flax ones for
``models/bridge.py``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from geometric_adv_tpu_torch.models.layers import BatchNorm
from geometric_adv_tpu_torch.ops.grouping import group_point, knn_point

GRID_SIZE = 45  # 45^2 = 2025 output points (reference: foldingnet.py:158-166)
NUM_KNN = 16


def folding_grid() -> np.ndarray:
    """reference: foldingnet.py:138-155 (meshgrid [-0.3, 0.3, 45]^2)."""
    xs = np.linspace(-0.3, 0.3, GRID_SIZE)
    ret = np.meshgrid(xs, xs)
    grid = np.zeros((GRID_SIZE * GRID_SIZE, 2), np.float32)
    for d in range(2):
        grid[:, d] = ret[d].reshape(-1)
    return grid


@torch.no_grad()
def graph_features(point_clouds: torch.Tensor):
    """(knn_idx [..., n, 16] int32, cov [..., n, 9]) (reference:
    prepare_graph.py:45-74)."""
    _, idx = knn_point(NUM_KNN + 1, point_clouds, point_clouds)
    nbr_idx = idx[..., 1:]  # drop self (reference uses nbsi[1:])
    nbrs = group_point(point_clouds, nbr_idx)  # [..., n, 16, 3]
    centered = nbrs - nbrs.mean(dim=-2, keepdim=True)
    # np.cov's default: unbiased (divide by k - 1)
    cov = torch.matmul(centered.transpose(-1, -2), centered) / (NUM_KNN - 1)
    return nbr_idx, cov.reshape(cov.shape[:-2] + (9,))


def graph_max_pool(features: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Max over each point's neighbours, then max with itself
    (reference: foldingnet.py:33-54)."""
    return torch.maximum(group_point(features, nbr_idx).amax(dim=-2), features)


class FoldingNetEncoder(nn.Module):
    """reference: foldingnet.py:57-104 (FoldingNetEnc_with_graph)."""

    def __init__(self, bn_momentum: float = 0.9):
        super().__init__()
        widths = ((12, 64), (64, 64), (64, 64), (64, 128), (128, 1024))
        for i, (fan_in, width) in enumerate(widths):
            self.add_module(f"conv{i + 1}", nn.Linear(fan_in, width))
            self.add_module(f"bn{i + 1}", BatchNorm(width, momentum=bn_momentum))
        self.fc1 = nn.Linear(1024, 512)
        self.bn6 = BatchNorm(512, momentum=bn_momentum)
        self.fc2 = nn.Linear(512, 512)

    def forward(self, x, cov, nbr_idx):
        h = torch.cat([x, cov], dim=-1)  # [..., n, 12]
        h = torch.relu(self.bn1(self.conv1(h)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = torch.relu(self.bn3(self.conv3(h)))
        h = torch.relu(graph_max_pool(h, nbr_idx))
        h = torch.relu(self.bn4(self.conv4(h)))
        h = torch.relu(graph_max_pool(h, nbr_idx))
        h = self.bn5(self.conv5(h)).amax(dim=-2)  # global max
        h = torch.relu(self.bn6(self.fc1(h)))
        return self.fc2(h)


class FoldingNetDecoder(nn.Module):
    """Two-fold grid decoder (reference: foldingnet.py:107-189)."""

    def __init__(self):
        super().__init__()
        for fold, fan_in in ((1, 514), (2, 515)):
            self.add_module(f"fold{fold}_conv1", nn.Linear(fan_in, 512))
            self.add_module(f"fold{fold}_conv2", nn.Linear(512, 512))
            self.add_module(f"fold{fold}_conv3", nn.Linear(512, 3))
        self.register_buffer("grid", torch.from_numpy(folding_grid()), persistent=False)

    def _fold(self, k: int, h: torch.Tensor) -> torch.Tensor:
        h = torch.relu(getattr(self, f"fold{k}_conv1")(h))
        h = torch.relu(getattr(self, f"fold{k}_conv2")(h))
        return getattr(self, f"fold{k}_conv3")(h)

    def forward(self, code: torch.Tensor):
        """-> (recon [..., 2025, 3], first fold [..., 2025, 3])."""
        m = self.grid.shape[0]
        code_rep = code[..., None, :].expand(code.shape[:-1] + (m, code.shape[-1]))
        grid_rep = self.grid.expand(code.shape[:-1] + (m, 2))
        p1 = self._fold(1, torch.cat([code_rep, grid_rep], dim=-1))
        return self._fold(2, torch.cat([code_rep, p1], dim=-1)), p1


class FoldingNet(nn.Module):
    """reference: foldingnet.py:192-206 (FoldingNet_graph)."""

    def __init__(self, bn_momentum: float = 0.9):
        super().__init__()
        self.encoder = FoldingNetEncoder(bn_momentum)
        self.decoder = FoldingNetDecoder()

    def encode(self, x, cov, nbr_idx):
        """-> code [..., 512]."""
        return self.encoder(x, cov, nbr_idx)

    def forward(self, x, cov, nbr_idx):
        """-> (recon [..., 2025, 3], first fold, code [..., 512])."""
        code = self.encode(x, cov, nbr_idx)
        recon, p1 = self.decoder(code)
        return recon, p1, code
