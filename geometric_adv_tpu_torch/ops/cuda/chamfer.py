"""ctypes wrappers of the hand-written chamfer kernels: K1, K2
(``csrc/nn_distance.cu``), K3, K4 (``csrc/chamfer_grad.cu``), K5
(``csrc/chamfer_payloads.cu``) and K8 with its preparation
(``csrc/nn_hier.cu``).

The shared library is built and loaded by ``ops/cuda/build.py``, which also
holds the checks every wrapper makes. Each wrapper launches on the current
CUDA stream without synchronising and adds one to its ``launches`` count per
kernel launch. There is no fallback: a CPU tensor, a failed build or a
refused launch raises. The plain PyTorch versions live in
``geometric_adv_tpu_torch/ops/chamfer.py`` and, for K8,
``geometric_adv_tpu_torch/ops/chamfer_hier.py``.
"""

from __future__ import annotations

import ctypes

import torch

from geometric_adv_tpu_torch.ops.cuda import build


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


@build.counted
def nn_distance_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """K1: (dist1 [b,n], idx1 [b,n] i32, dist2 [b,m], idx2 [b,m] i32).

    One launch for both directions."""
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    lib = build.load_library()
    opts = dict(device=xyz1.device)
    d1 = torch.empty((b, n), dtype=torch.float32, **opts)
    i1 = torch.empty((b, n), dtype=torch.int32, **opts)
    d2 = torch.empty((b, m), dtype=torch.float32, **opts)
    i2 = torch.empty((b, m), dtype=torch.int32, **opts)
    with torch.cuda.device(xyz1.device):
        build.check_launch(
            lib.gat_nn_distance(_ptr(xyz1), _ptr(xyz2), _ptr(d1), _ptr(i1), _ptr(d2),
                                _ptr(i2), b, n, m, torch.cuda.current_stream().cuda_stream),
            "nn_distance",
        )
        nn_distance_cuda.launches += 1
    return d1, i1, d2, i2


@build.counted
def nn_distance_values_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """K2: (dist1 [b,n], dist2 [b,m]) without the argmin. One launch."""
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    lib = build.load_library()
    d1 = torch.empty((b, n), dtype=torch.float32, device=xyz1.device)
    d2 = torch.empty((b, m), dtype=torch.float32, device=xyz1.device)
    with torch.cuda.device(xyz1.device):
        build.check_launch(
            lib.gat_nn_distance_values(_ptr(xyz1), _ptr(xyz2), _ptr(d1), _ptr(d2), b, n,
                                       m, torch.cuda.current_stream().cuda_stream),
            "nn_distance_values",
        )
        nn_distance_values_cuda.launches += 1
    return d1, d2


def _grad1(entry: str, xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    dev = xyz1.device
    build.check(idx1, "idx1", torch.int32, (b, n), dev)
    build.check(idx2, "idx2", torch.int32, (b, m), dev)
    build.check(g1, "g1", torch.float32, (b, n), dev)
    build.check(g2, "g2", torch.float32, (b, m), dev)
    lib = build.load_library()
    out = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        build.check_launch(
            getattr(lib, entry)(
                _ptr(xyz1), _ptr(xyz2), _ptr(idx1), _ptr(idx2), _ptr(g1),
                _ptr(g2), _ptr(out), b, n, m,
                torch.cuda.current_stream().cuda_stream,
            ),
            entry,
        )
    return out


@build.counted
def chamfer_grad1_cuda(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """K3: gradient of sum(g1*dist1) + sum(g2*dist2) wrt xyz1, [b, n, 3]."""
    out = _grad1("gat_chamfer_grad1", xyz1, xyz2, idx1, idx2, g1, g2)
    chamfer_grad1_cuda.launches += 1
    return out


@build.counted
def chamfer_grad1_vpu_cuda(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """K4: K3's contract in the masked-reduction algebra of
    ``chamfer_grad1_pallas_vpu``, [b, n, 3]."""
    out = _grad1("gat_chamfer_grad1_vpu", xyz1, xyz2, idx1, idx2, g1, g2)
    chamfer_grad1_vpu_cuda.launches += 1
    return out


@build.counted
def chamfer_loss_payloads_cuda(x1: torch.Tensor, x2: torch.Tensor):
    """K5: (d1 [b,n], i1 [b,n] i32, d2 [b,m], i2 [b,m] i32, nn1 [b,n,3],
    snn1 [b,n,3], cnt1 [b,n]).

    Two kernels per call (K1's, then the O(n + m) payload pass), counted as
    one launch of K5."""
    b, n, m = build.cloud_sizes(x1, x2)
    lib = build.load_library()
    opts = dict(dtype=torch.float32, device=x1.device)
    d1 = torch.empty((b, n), **opts)
    i1 = torch.empty((b, n), dtype=torch.int32, device=x1.device)
    d2 = torch.empty((b, m), **opts)
    i2 = torch.empty((b, m), dtype=torch.int32, device=x1.device)
    nn1 = torch.empty((b, n, 3), **opts)
    snn1 = torch.empty((b, n, 3), **opts)
    cnt1 = torch.empty((b, n), **opts)
    with torch.cuda.device(x1.device):
        build.check_launch(
            lib.gat_chamfer_loss_payloads(
                _ptr(x1), _ptr(x2), _ptr(d1), _ptr(i1), _ptr(d2), _ptr(i2),
                _ptr(nn1), _ptr(snn1), _ptr(cnt1), b, n, m,
                torch.cuda.current_stream().cuda_stream,
            ),
            "chamfer_loss_payloads",
        )
        chamfer_loss_payloads_cuda.launches += 1
    return d1, i1, d2, i2, nn1, snn1, cnt1


HIER_BLOCK = 128  # sorted points per bounding sphere (csrc/nn_hier.cu kBlock)
HIER_PREP_CAP = 16384  # points a cloud hier_prep_cuda sorts in one launch (kPrepCap)
HIER_TILE = 32  # queries of one vote of K8: a warp's, one a lane


def _aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (read as float4)")


@build.counted
def hier_prep_cuda(x: torch.Tensor, y: torch.Tensor | None = None, with_codes: bool = False):
    """K8's preparation of the clouds of x [b, n, 3] and, if given,
    y [b, m, 3]: each cloud Morton-sorted (stable) and cut into blocks of
    ``HIER_BLOCK`` points with their bounding spheres. Returns a tuple with
    one entry per batch: (pts4 [b, k, 4], the sorted points with the bits of
    each one's original int32 id in w; spheres [b, ceil(k / HIER_BLOCK), 4];
    the Morton codes [b, k] int32 in original order, or None). One launch up
    to ``HIER_PREP_CAP`` points a cloud, the sort in shared memory; past it,
    the sort merges through a workspace of 8 bytes a key in several launches,
    counted as one."""
    b, n, m = build.cloud_sizes(x, x if y is None else y)
    lib = build.load_library()
    sizes = (n,) if y is None else (n, m)
    keys = None
    if max(sizes) > HIER_PREP_CAP:  # [batches, b, the power of two >= every k]
        pow2 = 1 << (max(sizes) - 1).bit_length()
        keys = torch.empty(len(sizes) * b * pow2, dtype=torch.int64, device=x.device)
    # one allocation, cut into each batch's cloud [b, k, 4] and spheres
    spans = [(b * k * 4, b * -(-k // HIER_BLOCK) * 4) for k in sizes]
    buf = torch.empty(sum(map(sum, spans)), dtype=torch.float32, device=x.device)
    outs, at = [], 0
    for k, (pts, sph) in zip(sizes, spans):
        outs.append((buf[at:at + pts].view(b, k, 4),
                     buf[at + pts:at + pts + sph].view(b, -1, 4),
                     torch.empty((b, k), dtype=torch.int32, device=x.device)
                     if with_codes else None))
        at += pts + sph

    def ptrs(i):
        return [None] * 4 if i >= len(outs) else [
            _ptr(x if i == 0 else y), *(None if t is None else _ptr(t) for t in outs[i])]

    with torch.cuda.device(x.device):
        build.check_launch(
            lib.gat_hier_prep(*ptrs(0), *ptrs(1), None if keys is None else _ptr(keys), b, n,
                              m, torch.cuda.current_stream().cuda_stream),
            "hier_prep",
        )
        hier_prep_cuda.launches += 1
    return tuple(outs)


@build.counted
def nn_direction_hier_cuda(directions, with_idx: bool = True):
    """K8, one launch for one or two directions. Each direction is (q, o4,
    cyr): the queries q [b, n, 3] (results in their order) or [b, n, 4] (a
    prepared cloud from ``hier_prep_cuda``: results at the original ids in
    w), the other cloud prepared, o4 [b, m, 4], and its spheres cyr
    [b, ceil(m / HIER_BLOCK), 4]. Returns per direction (min squared
    distance [b, n], smallest original id attaining it int32 [b, n] or None
    without ``with_idx``), pruned over the spheres, each query's bound seeded
    in the kernel. The launcher refuses an other cloud whose spheres do not
    fit its shared memory beside a staged chunk (past ~1.3 million points),
    and the refusal raises."""
    if len(directions) not in (1, 2):
        raise ValueError(f"K8 takes one or two directions, got {len(directions)}")
    dev = directions[0][0].device
    b = directions[0][0].shape[0]
    shapes = []
    for q, o4, cyr in directions:
        if q.dim() != 3 or q.shape[-1] not in (3, 4) or o4.dim() != 3:
            raise ValueError(f"K8 takes queries [b, n, 3|4] and a prepared cloud "
                             f"[b, m, 4], got {tuple(q.shape)} and {tuple(o4.shape)}")
        n, s, m = q.shape[1], q.shape[2], o4.shape[1]
        nb = -(-m // HIER_BLOCK)
        if min(n, m) == 0 or b * max(n, m) * 4 >= 2**31:
            raise ValueError(f"K8 cannot take b={b}, n={n}, m={m}")
        build.check(q, "q", torch.float32, (b, n, s), dev)
        build.check(o4, "o4", torch.float32, (b, m, 4), dev)
        build.check(cyr, "cyr", torch.float32, (b, nb, 4), dev)
        _aligned(o4, "o4")
        _aligned(cyr, "cyr")
        shapes.append((n, s, m))
    # one allocation: each direction's dist (as float32) and idx
    per = 2 if with_idx else 1
    buf = torch.empty(per * b * sum(n for n, _, _ in shapes), dtype=torch.int32, device=dev)
    args, outs, at = [], [], 0
    for (q, o4, cyr), (n, s, m) in zip(directions, shapes):
        dist = buf[at:at + b * n].view(torch.float32).view(b, n)
        idx = buf[at + b * n:at + 2 * b * n].view(b, n) if with_idx else None
        at += per * b * n
        outs.append((dist, idx))
        args.append([_ptr(q), s, _ptr(o4), _ptr(cyr), _ptr(dist),
                     None if idx is None else _ptr(idx), n, m])
    if len(args) == 1:
        args.append([None, 0, None, None, None, None, 0, 0])
    lib = build.load_library()
    with torch.cuda.device(dev):
        build.check_launch(
            lib.gat_nn_direction_hier(*args[0], *args[1], b,
                                      torch.cuda.current_stream().cuda_stream),
            "nn_direction_hier",
        )
        nn_direction_hier_cuda.launches += 1
    return outs


def hier_blocks_per_sm(m: int) -> int:
    """K8's thread blocks resident on one SM against an other cloud of m
    points (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = build.load_library()
    out = (ctypes.c_int * 1)()
    build.check_launch(lib.gat_hier_blocks_per_sm(m, ctypes.addressof(out)),
                       "hier_blocks_per_sm")
    return out[0]


WRAPPERS = (nn_distance_cuda, nn_distance_values_cuda, chamfer_grad1_cuda,
            chamfer_grad1_vpu_cuda, chamfer_loss_payloads_cuda,
            hier_prep_cuda, nn_direction_hier_cuda)


def reset_launch_counts() -> None:
    build.reset_launch_counts(WRAPPERS)


def launch_counts() -> dict[str, int]:
    return build.launch_counts(WRAPPERS)
