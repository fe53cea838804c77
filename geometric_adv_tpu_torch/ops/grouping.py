"""kNN / grouping ops (``geometric_adv_tpu/ops/grouping.py``; the
reference's ``tf_grouping`` CUDA library, external/grouping/tf_grouping.py:
8-75):

    query_ball_point(radius, nsample, xyz1[b,n,3], xyz2[b,m,3])
        -> idx[b,m,nsample] int32, pts_cnt[b,m] int32
    select_top_k(k, dist[b,m,n]) -> (idx[b,m,n] int32, dist_out[b,m,n])
    group_point(points[b,n,c], idx[b,m,s]) -> [b,m,s,c]
    knn_point(k, xyz1[b,n,c], xyz2[b,m,c]) -> (dist[b,m,k], idx[b,m,k] int32)

Every selection breaks ties by the lower index, like the reference's
selection sort (strict ``<``, tf_grouping_g.cu:80-122) and ``lax.top_k``:
``knn_point`` takes the k smallest of packed (distance bits, index) int64
keys, which are unique, and the sorts are stable. ``group_point``'s
gradient is ``torch.gather``'s backward, the scatter-add of
tf_grouping_g.cu:59-76. These are PyTorch compositions on the device of
their inputs, as the JAX package's are XLA ones.
"""

from __future__ import annotations

import math

import torch

from geometric_adv_tpu_torch.ops.chamfer import pairwise_sqdist

# Elements of the [b, rows, n] distance plane ``knn_point`` forms at once:
# it walks the queries in blocks of rows so that its transient (the
# [b, rows, n, 3] differences, the int64 keys) stays below the full plane
# (5 GB of differences at the defense's 100 x 2048^2).
KNN_BLOCK_ELEMS = 1 << 25


def _knn_block(k, xyz1, q):
    sqd = pairwise_sqdist(q, xyz1)  # [..., rows, n], never negative
    ids = torch.arange(xyz1.shape[-2], device=xyz1.device)
    keys = (sqd.view(torch.int32).to(torch.int64) << 32) | ids
    best = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    dist = (best >> 32).to(torch.int32).view(torch.float32)
    return dist, (best & 0xFFFFFFFF).to(torch.int32)


def knn_point(k: int, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """k nearest dataset points (``xyz1`` [..., n, c]) for each query point
    (``xyz2`` [..., m, c]): (squared distances [..., m, k] ascending,
    indices [..., m, k] int32), equal distances in index order. Squared
    distances are non-negative, so their float bits order as int32 and a
    key's high word orders the distances (a NaN's bits sort above inf)."""
    n, m = xyz1.shape[-2], xyz2.shape[-2]
    rows = max(1, KNN_BLOCK_ELEMS // max(1, math.prod(xyz2.shape[:-2]) * n))
    parts = [_knn_block(k, xyz1, xyz2[..., s:s + rows, :]) for s in range(0, m, rows)]
    dist, idx = zip(*parts)
    return torch.cat(dist, dim=-2), torch.cat(idx, dim=-2)


def select_top_k(k: int, dist: torch.Tensor):
    """(idx, dist_out): the full stable ascending sort of the last axis, as
    the JAX package does (its first k slots are the contract's k smallest;
    the reference returns full [b, m, n] outputs)."""
    del k
    out, order = torch.sort(dist, dim=-1, stable=True)
    return order.to(torch.int32), out


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather point features by index: [..., n, c], [..., m, s] ->
    [..., m, s, c]; differentiable in ``points``."""
    m, s = idx.shape[-2], idx.shape[-1]
    flat = idx.reshape(idx.shape[:-2] + (m * s,)).long()
    gathered = torch.gather(
        points, -2, flat[..., None].expand(flat.shape + (points.shape[-1],)))
    return gathered.reshape(idx.shape[:-2] + (m, s, points.shape[-1]))


def query_ball_point(radius: float, nsample: int, xyz1: torch.Tensor,
                     xyz2: torch.Tensor):
    """Indices of the first ``nsample`` dataset points (in index order)
    within ``radius`` (strict ``<`` on the squared distance) of each query,
    the rest of a row padded with its first hit; ``pts_cnt`` counts the hits
    up to nsample. A row with no hit is all zeros with pts_cnt 0
    (grouping.py:86-123)."""
    n = xyz1.shape[-2]
    sqd = pairwise_sqdist(xyz2, xyz1)  # [..., m, n]
    hit = sqd < radius * radius
    rank = torch.cumsum(hit.to(torch.int32), dim=-1) - 1
    pts_cnt = torch.clamp_max(hit.sum(dim=-1), nsample).to(torch.int32)
    point_ids = torch.arange(n, dtype=torch.int32, device=xyz1.device)
    # hits keep their rank (< nsample), the rest sort after them
    key = torch.where(hit & (rank < nsample), rank, n + point_ids)
    idx = torch.argsort(key, dim=-1, stable=True)[..., :nsample].to(torch.int32)
    slot = torch.arange(idx.shape[-1], dtype=torch.int32, device=xyz1.device)
    valid = slot < torch.clamp_min(pts_cnt, 1)[..., None]
    idx = torch.where(valid, idx, idx[..., :1])
    idx = torch.where(pts_cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx, pts_cnt
