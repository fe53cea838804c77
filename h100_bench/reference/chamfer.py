"""The chamfer distance in plain PyTorch, float32.

Per cloud, mean(d1) + mean(d2) of the squared distances from each point to
its nearest neighbour in the other cloud (Achlioptas et al. 2018, eq. 1).
A squared distance is formed as ((dx*dx) + (dy*dy)) + (dz*dz). The nearest
indices are searched without gradients, in blocks of rows so that the
distance plane fits; the distances are then formed again from the gathered
neighbours, so autograd gives the nearest-neighbour (scatter-add) gradient.
"""

from __future__ import annotations

import torch

BLOCK_ELEMENTS = 1 << 26  # distance entries a block of the search holds


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3] x [..., 3] -> [...]: ((dx*dx) + (dy*dy)) + (dz*dz)."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


@torch.no_grad()
def nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, n] index of each point of ``a`` [B, n, 3]'s nearest in ``b`` [B, m, 3]."""
    bsz, n, _ = a.shape
    m = b.shape[1]
    rows = max(1, BLOCK_ELEMENTS // (bsz * m))
    out = []
    for s in range(0, n, rows):
        blk = a[:, s:s + rows]
        out.append(sqdist(blk[:, :, None, :], b[:, None, :, :]).argmin(dim=-1))
    return torch.cat(out, dim=1)


def gather(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(pts, 1, idx[..., None].expand(idx.shape + (3,)))


def chamfer_terms(a: torch.Tensor, b: torch.Tensor):
    """(d1 [B, n], d2 [B, m]): each point's squared distance to its nearest
    neighbour in the other cloud, differentiable in both clouds."""
    i1, i2 = nearest(a, b), nearest(b, a)
    return sqdist(a, gather(b, i1)), sqdist(b, gather(a, i2))


def chamfer_per_pc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d1, d2 = chamfer_terms(a, b)
    return d1.mean(dim=-1) + d2.mean(dim=-1)
