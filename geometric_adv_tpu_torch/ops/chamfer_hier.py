"""Exact chamfer with bounding-sphere pruning over Morton-sorted blocks
(``geometric_adv_tpu/ops/pallas/chamfer_hier_kernel.py``; kernel K8).

No route of the package calls it, as in the JAX package, which recorded it
as a negative result on the TPU; it is an op entry held against ``nn_distance``.
The steps:

1. both clouds are prepared: Morton-sorted (10 bits per axis, a stable
   sort) so that neighbouring points are neighbours in space, and cut into
   blocks of ``BS`` sorted points, each with a bounding sphere (box centre,
   radius inflated by ``_R_MARGIN``). A prepared cloud is [b, k, 4]: the
   sorted points with the bits of each one's original int32 id in the last
   column;
2. each query gets a true upper bound on its NN distance from the other
   cloud's spheres, ``min_j (|x - c_j| + r_j)^2``, inflated;
3. each tile of ``NT`` queries (one warp's) visits the blocks nearest
   first (by the tile's least lower bound ``lb = max(0, |x - c| - r)^2``,
   deflated) and skips a block when none of its queries has ``lb <= cur``,
   ``cur`` the query's running minimum, a packed key (distance, original
   id) that starts at (upper bound, 2^30); results go to the queries'
   original positions.

Since ``lb`` never exceeds the distance to any point of the block, the
result equals ``nn_distance``: the same values, and indices with ties to the
lowest original id. The margins keep float32 rounding in the bounds from
pruning the argmin. A query with a NaN coordinate gets NaN and index 2^30; a
NaN point of the other cloud is never taken while a finite distance exists
(its key lies above every finite key). Clouds with NaN are otherwise outside
the contract: their sort and spheres are not held to any reference.

On CUDA tensors ``nn_distance_hier`` is two launches: the preparation kernel
for both clouds (``ops/cuda/chamfer.py::hier_prep_cuda``) and K8 for both
directions (``nn_direction_hier_cuda``); past ``PREP_CAP`` points a cloud
the preparation's sort merges through global memory in a few more launches.
On the CPU both are their plain versions here, the same algorithms with the
same vote.
"""

from __future__ import annotations

import torch

from geometric_adv_tpu_torch.ops.chamfer import _on_cuda, _take_points, pairwise_sqdist
from geometric_adv_tpu_torch.ops.cuda import chamfer as _cuda

BS = _cuda.HIER_BLOCK  # sorted points per bounding sphere
NT = _cuda.HIER_TILE  # query points per tile, the unit of the skip vote
PREP_CAP = _cuda.HIER_PREP_CAP  # points a cloud the preparation sorts in one launch
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


def cloud_ids(pts4: torch.Tensor) -> torch.Tensor:
    """The original int32 ids of a prepared cloud [b, k, 4], in sorted
    order (a view of its last column)."""
    return pts4[..., 3].view(torch.int32)


def prepare_plain(pts: torch.Tensor):
    """Plain version of the preparation kernel (``hier_prep_cuda``) for one
    [b, k, 3] cloud batch: (prepared cloud [b, k, 4], spheres)."""
    srt, perm = sort_cloud(pts)
    pts4 = torch.cat([srt, perm.view(torch.float32)[..., None]], dim=-1)
    return pts4, build_block_structure(srt)


def prepare(*clouds: torch.Tensor):
    """Prepare one or two [b, k, 3] cloud batches; -> one (prepared cloud,
    spheres) per batch. On CUDA tensors the preparation kernel for all of
    them, on the CPU the plain preparation."""
    clouds = tuple(c.float().contiguous() for c in clouds)
    if _on_cuda(clouds[0]):
        return tuple(p[:2] for p in _cuda.hier_prep_cuda(*clouds))
    return tuple(prepare_plain(c) for c in clouds)


def _pack(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The kernel's key (bits of d) << 32 | id, unsigned, as an int64 of the
    same order: the sign bit of the high word is flipped."""
    hi = (d.contiguous().view(torch.int32) ^ -2**31).to(torch.int64)
    return hi * 2**32 + ids.to(torch.int64)


def _unpack(key: torch.Tensor):
    bits = ((key >> 32) ^ -2**31).to(torch.int32)
    return bits.view(torch.float32), (key & 0xFFFFFFFF).to(torch.int32)


def lower_bounds(x: torch.Tensor, cyr: torch.Tensor) -> torch.Tensor:
    """The lower bound of |x - p|^2 over each sphere's points, for [b, n, 3]
    queries: ``max(0, |x - c| - r)^2``, deflated; [b, n, nb]."""
    gap = torch.clamp(torch.sqrt(pairwise_sqdist(x, cyr[..., :3])) - cyr[:, None, :, 3],
                      min=0.0)
    return gap * gap * _LB_MARGIN - _ABS_MARGIN


def visit_order(lb: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The order in which a tile of ``NT`` queries visits the blocks: by the
    tile's least lower bound over its valid queries, ties by block;
    [b, tiles, nb] block indices. (The kernel ranks the blocks so within
    each chunk it stages; the results do not depend on the order.)"""
    b, n, nb = lb.shape
    tile_lb = lb.masked_fill(~valid[..., None], float("inf"))
    tile_lb = tile_lb.reshape(b, n // NT, NT, nb).amin(dim=2)
    return torch.argsort(tile_lb, dim=-1, stable=True)


def nn_direction_hier_plain(q: torch.Tensor, o4: torch.Tensor, cyr: torch.Tensor,
                            with_idx: bool = True):
    """Plain version of kernel K8 (``nn_direction_hier_cuda``), one
    direction: the queries q [b, n, 3] (results in their order) or a
    prepared cloud [b, n, 4] (results at its original ids) against the
    prepared o4 [b, m, 4] with spheres cyr. The same visit of the blocks
    (``visit_order``), each taken only where some query of an ``NT``-point
    tile has ``lb <= cur``, the same packed-key minimum; -> (dist [b, n],
    idx [b, n] int32 or None)."""
    b, n, _ = q.shape
    m, nb = o4.shape[1], cyr.shape[1]
    tiles = -(-n // NT)
    pad = tiles * NT - n
    x = q[..., :3].contiguous()
    bad = torch.isnan(x).any(dim=-1)
    valid = torch.nn.functional.pad(~bad, (0, pad))
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    lb = lower_bounds(xp, cyr)
    order = visit_order(lb, valid)
    # the blocks [b, nb, BS], a ragged last one padded with keys that never win
    fill = nb * BS - m
    yb = torch.nn.functional.pad(o4[..., :3], (0, 0, 0, fill)).reshape(b, nb, BS, 3)
    ib = torch.nn.functional.pad(cloud_ids(o4), (0, fill)).reshape(b, nb, BS)
    pads = (torch.arange(nb * BS, device=q.device) >= m).reshape(nb, BS)
    ub = seed_upper_bounds(xp, cyr)
    key = _pack(ub, torch.full_like(ub, _BIG_IDX, dtype=torch.int32)).reshape(b, tiles, NT)
    xt, lbt = xp.reshape(b, tiles, NT, 3), lb.reshape(b, tiles, NT, nb)
    vt = valid.reshape(b, tiles, NT)
    for k in range(nb):
        jb = order[..., k]  # [b, tiles]
        lbq = torch.gather(lbt, 3, jb[:, :, None, None].expand(b, tiles, NT, 1))[..., 0]
        need = ((lbq <= _unpack(key)[0]) & vt).any(dim=-1, keepdim=True)
        pts = torch.gather(yb, 1, jb[..., None, None].expand(b, tiles, BS, 3))
        ids = torch.gather(ib, 1, jb[..., None].expand(b, tiles, BS))
        keys = _pack(pairwise_sqdist(xt, pts), ids[:, :, None, :])
        keys = keys.masked_fill(pads[jb][:, :, None, :], torch.iinfo(torch.int64).max)
        key = torch.where(need, torch.minimum(key, keys.amin(dim=-1)), key)
    dist, idx = (t.reshape(b, tiles * NT)[:, :n] for t in _unpack(key))
    dist = dist.masked_fill(bad, float("nan"))
    idx = idx.masked_fill(bad, _BIG_IDX)
    if q.shape[-1] == 4:  # to the original positions
        pos = cloud_ids(q).long()
        dist = torch.empty_like(dist).scatter_(1, pos, dist)
        idx = torch.empty_like(idx).scatter_(1, pos, idx)
    return dist, idx if with_idx else None


def nn_hier(directions, with_idx: bool = True):
    """K8 for one or two directions (q, o4, cyr) in one launch on CUDA
    tensors, its plain version on the CPU; -> [(dist, idx or None)]."""
    if _on_cuda(directions[0][0]):
        return _cuda.nn_direction_hier_cuda(directions, with_idx)
    return [nn_direction_hier_plain(*d, with_idx) for d in directions]


def nn_direction_sorted(x: torch.Tensor, y: torch.Tensor, with_idx: bool = True):
    """For each x[i] of [b, n, 3]: (min_j |x_i - y_j|^2, the smallest
    original j attaining it, or None without ``with_idx``), pruned. x keeps
    its order; a Morton-sorted x prunes best."""
    ((y4, cyr),) = prepare(y)
    ((d, i),) = nn_hier([(x.float().contiguous(), y4, cyr)], with_idx)
    return d, i


def nn_distance_hier(x: torch.Tensor, y: torch.Tensor):
    """``nn_distance``'s forward by pruned directions: [..., n, 3],
    [..., m, 3] -> (d1, i1, d2, i2) in the original point order, first index
    on ties. Each cloud is prepared once, as queries and as blocks."""
    lead = x.shape[:-2]
    n, m = x.shape[-2], y.shape[-2]
    (x4, cyr_x), (y4, cyr_y) = prepare(x.reshape(-1, n, 3), y.reshape(-1, m, 3))
    (d1, i1), (d2, i2) = nn_hier([(x4, y4, cyr_y), (y4, x4, cyr_x)])
    return (d1.reshape(lead + (n,)), i1.reshape(lead + (n,)),
            d2.reshape(lead + (m,)), i2.reshape(lead + (m,)))
