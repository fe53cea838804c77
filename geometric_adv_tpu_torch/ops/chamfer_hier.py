"""Exact chamfer with bounding-sphere pruning over Morton-sorted blocks
(``geometric_adv_tpu/ops/pallas/chamfer_hier_kernel.py``; kernel K8).

No route of the package calls it, as in the JAX package, which recorded it
as a negative result on the TPU; it is an op entry held against ``nn_distance``.
The steps:

1. both clouds are Morton-sorted (10 bits per axis, codes in int64, a
   stable sort) so that neighbouring points are neighbours in space;
2. the sorted other cloud is cut into blocks of ``BS`` points, each with a
   bounding sphere (box centre, radius inflated by ``_R_MARGIN``);
3. each query gets a true upper bound on its NN distance,
   ``min_j (|x - c_j| + r_j)^2``, inflated;
4. the direction kernel visits the blocks in order and skips a block when no
   point of a ``NT``-point query tile has ``lb <= cur``, where ``lb`` is the
   block's lower bound: ``max(0, |x - c| - r)^2``, deflated.

Since ``lb`` never exceeds the distance to any point of the block, the
result equals ``nn_distance``: the same values, and indices with ties to the
lowest original id. The margins keep float32 rounding in the bounds from
pruning the argmin. On a CUDA tensor the direction runs K8
(``ops/cuda/chamfer.py::nn_direction_hier_cuda``); on the CPU its plain
version here, the same algorithm with the same tile-wide bound test.
"""

from __future__ import annotations

import torch

from geometric_adv_tpu_torch.ops.chamfer import _on_cuda, _take_points, pairwise_sqdist
from geometric_adv_tpu_torch.ops.cuda import chamfer as _cuda

BS = _cuda.HIER_BLOCK  # sorted points per bounding sphere
NT = 128  # query points per tile, the unit of the skip vote (csrc kThreads)
_BIG_IDX = 2**30
_R_MARGIN = 1.0 + 1e-4
_LB_MARGIN = 1.0 - 1e-5
_UB_MARGIN = 1.0 + 1e-5
_ABS_MARGIN = 1e-12


def morton_codes(pts: torch.Tensor) -> torch.Tensor:
    """[..., k, 3] f32 -> [..., k] int64 Morton codes, 10 bits per axis, in
    the per-cloud bounding box."""
    lo = pts.amin(dim=-2, keepdim=True)
    hi = pts.amax(dim=-2, keepdim=True)
    # a true division: ``1023.0 / t`` would multiply by t's reciprocal and
    # round differently
    scale = pts.new_tensor(1023.0) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((pts - lo) * scale, 0.0, 1023.0).to(torch.int64)

    def spread(v):  # interleave 10 bits with two zero bits
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)


def sort_cloud(pts: torch.Tensor):
    """Morton-sort [b, k, 3]: (sorted, perm) with sorted[i] == pts[perm[i]]
    (perm int32, the original ids in sorted order; ties keep their order)."""
    perm = torch.argsort(morton_codes(pts), dim=-1, stable=True).to(torch.int32)
    return _take_points(pts, perm), perm


def build_block_structure(ys: torch.Tensor, bs: int = BS) -> torch.Tensor:
    """Bounding spheres of the blocks of ``bs`` points of a sorted [b, m, 3]
    cloud: [b, ceil(m / bs), 4] of (centre xyz, inflated radius). A ragged
    last block is padded with copies of the last point, which leave its box
    and radius those of its own points."""
    b, m, _ = ys.shape
    nb = -(-m // bs)
    pad = nb * bs - m
    if pad:
        ys = torch.cat([ys, ys[:, -1:].expand(b, pad, 3)], dim=1)
    blocks = ys.reshape(b, nb, bs, 3)
    c = 0.5 * (blocks.amin(dim=2) + blocks.amax(dim=2))
    d = blocks - c[:, :, None, :]
    r = torch.sqrt((d * d).sum(dim=-1).amax(dim=-1))
    r = r * _R_MARGIN + 1e-9
    return torch.cat([c, r[..., None]], dim=-1).contiguous()


def seed_upper_bounds(x: torch.Tensor, cyr: torch.Tensor) -> torch.Tensor:
    """True NN-distance upper bounds of the [b, n, 3] queries:
    ``min_j (|x - c_j| + r_j)^2``, inflated; [b, n]."""
    d2 = pairwise_sqdist(x, cyr[..., :3])
    ub = ((torch.sqrt(d2) + cyr[:, None, :, 3]) ** 2).amin(dim=-1)
    return ub * _UB_MARGIN + _ABS_MARGIN


def nn_direction_hier_plain(x, ub, ys, oy, cyr, with_idx: bool = True):
    """Plain version of kernel K8 (``nn_direction_hier_cuda``): the same
    visit of the blocks in order, each taken only where some query of an
    ``NT``-point tile has ``lb <= cur``; ties to the lowest original id."""
    b, n, _ = x.shape
    m = ys.shape[1]
    tiles = -(-n // NT)
    pad = tiles * NT - n
    valid = torch.arange(tiles * NT, device=x.device) < n
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    cur = torch.nn.functional.pad(ub, (0, pad))
    icur = torch.full_like(cur, _BIG_IDX, dtype=torch.int32)
    for j in range(cyr.shape[1]):
        c, r = cyr[:, None, j, :3], cyr[:, None, j, 3]
        d = xp - c
        dc = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        gap = torch.clamp(torch.sqrt(dc) - r, min=0.0)
        lb = gap * gap * _LB_MARGIN - _ABS_MARGIN
        need = ((lb <= cur) & valid).reshape(b, tiles, NT).any(dim=-1)
        need = need.repeat_interleave(NT, dim=1)
        sl = slice(j * BS, min((j + 1) * BS, m))
        dist = pairwise_sqdist(xp, ys[:, sl])
        tmin = dist.amin(dim=-1)
        ids = torch.where(dist == tmin[..., None], oy[:, None, sl], _BIG_IDX)
        targ = ids.amin(dim=-1)
        better = need & (tmin < cur)
        tie = need & (tmin == cur)
        icur = torch.where(better, targ,
                           torch.where(tie, torch.minimum(icur, targ), icur))
        cur = torch.where(better, tmin, cur)
    return cur[:, :n], icur[:, :n] if with_idx else None


def nn_direction(x, ub, ys, oy, cyr, with_idx: bool = True):
    """K8 on a CUDA tensor, its plain version on the CPU."""
    if _on_cuda(x):
        return _cuda.nn_direction_hier_cuda(x, ub, ys, oy, cyr, with_idx)
    return nn_direction_hier_plain(x, ub, ys, oy, cyr, with_idx)


def _prep(pts: torch.Tensor):
    """Sort a [b, k, 3] cloud once; -> (sorted, perm, block spheres)."""
    srt, perm = sort_cloud(pts.float().contiguous())
    return srt, perm, build_block_structure(srt)


def nn_direction_sorted(x: torch.Tensor, y: torch.Tensor, with_idx: bool = True):
    """For each x[i] of [b, n, 3]: (min_j |x_i - y_j|^2, the smallest
    original j attaining it, or None without ``with_idx``), pruned. x keeps
    its order; a Morton-sorted x prunes best."""
    ys, perm, cyr = _prep(y)
    x = x.float().contiguous()
    return nn_direction(x, seed_upper_bounds(x, cyr), ys, perm, cyr, with_idx)


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    iota = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.empty_like(perm).scatter_(-1, perm.long(), iota.expand_as(perm))


def nn_distance_hier(x: torch.Tensor, y: torch.Tensor):
    """``nn_distance``'s forward by pruned direction kernels: [..., n, 3],
    [..., m, 3] -> (d1, i1, d2, i2) in the original point order, first
    index on ties. Each cloud is sorted once, as query and as blocks."""
    lead = x.shape[:-2]
    n, m = x.shape[-2], y.shape[-2]
    xs, perm_x, cyr_x = _prep(x.reshape(-1, n, 3))
    ys, perm_y, cyr_y = _prep(y.reshape(-1, m, 3))
    d1s, i1s = nn_direction(xs, seed_upper_bounds(xs, cyr_y), ys, perm_y, cyr_y)
    d2s, i2s = nn_direction(ys, seed_upper_bounds(ys, cyr_x), xs, perm_x, cyr_x)
    inv_x = _inverse_perm(perm_x).long()
    inv_y = _inverse_perm(perm_y).long()
    return (torch.gather(d1s, -1, inv_x).reshape(lead + (n,)),
            torch.gather(i1s, -1, inv_x).reshape(lead + (n,)),
            torch.gather(d2s, -1, inv_y).reshape(lead + (m,)),
            torch.gather(i2s, -1, inv_y).reshape(lead + (m,)))
