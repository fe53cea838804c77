"""ctypes wrappers of the hand-written chamfer kernels: K1, K2
(``csrc/nn_distance.cu``), K3, K4 (``csrc/chamfer_grad.cu``), K5
(``csrc/chamfer_payloads.cu``) and K8 (``csrc/nn_hier.cu``).

The shared library is built and loaded by ``ops/cuda/build.py``, which also
holds the checks every wrapper makes. Each wrapper launches on the current
CUDA stream without synchronising and adds one to its ``launches`` count per
kernel launch. There is no fallback: a CPU tensor, a failed build or a
refused launch raises. The plain PyTorch versions live in
``geometric_adv_tpu_torch/ops/chamfer.py`` and, for K8,
``geometric_adv_tpu_torch/ops/chamfer_hier.py``.
"""

from __future__ import annotations

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


HIER_BLOCK = 128  # sorted y points per bounding sphere (csrc/nn_hier.cu kBlock)


@build.counted
def nn_direction_hier_cuda(x, ub, ys, oy, cyr, with_idx: bool = True):
    """K8: for each x point, (min squared distance to ys, smallest original
    id ``oy`` attaining it, or None without ``with_idx``), pruned over the
    blocks of ``HIER_BLOCK`` sorted points whose spheres are ``cyr``
    [b, ceil(m / HIER_BLOCK), 4]; ``ub`` [b, n] seeds the running minimum."""
    b, n, m = build.cloud_sizes(x, ys)
    dev = x.device
    nb = -(-m // HIER_BLOCK)
    build.check(ub, "ub", torch.float32, (b, n), dev)
    build.check(oy, "oy", torch.int32, (b, m), dev)
    build.check(cyr, "cyr", torch.float32, (b, nb, 4), dev)
    if cyr.data_ptr() % 16:
        raise ValueError("cyr must be 16-byte aligned (read as float4)")
    lib = build.load_library()
    dist = torch.empty((b, n), dtype=torch.float32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int32, device=dev) if with_idx else None
    with torch.cuda.device(dev):
        build.check_launch(
            lib.gat_nn_direction_hier(
                _ptr(x), _ptr(ub), _ptr(ys), _ptr(oy), _ptr(cyr), _ptr(dist),
                None if idx is None else _ptr(idx), b, n, m,
                torch.cuda.current_stream().cuda_stream,
            ),
            "nn_direction_hier",
        )
        nn_direction_hier_cuda.launches += 1
    return dist, idx


WRAPPERS = (nn_distance_cuda, nn_distance_values_cuda, chamfer_grad1_cuda,
            chamfer_grad1_vpu_cuda, chamfer_loss_payloads_cuda,
            nn_direction_hier_cuda)


def reset_launch_counts() -> None:
    build.reset_launch_counts(WRAPPERS)


def launch_counts() -> dict[str, int]:
    return build.launch_counts(WRAPPERS)
