"""ctypes wrappers of the hand-written chamfer kernels K1-K3
(``csrc/nn_distance.cu``, ``csrc/chamfer_grad.cu``).

The shared library is built and loaded by ``ops/cuda/build.py``, which also
holds the checks every wrapper makes. Each wrapper launches on the current
CUDA stream without synchronising and adds one to its ``launches`` count per
kernel launch. There is no fallback: a CPU tensor, a failed build or a
refused launch raises. The plain PyTorch versions live in
``geometric_adv_tpu_torch/ops/chamfer.py``.
"""

from __future__ import annotations

import torch

from geometric_adv_tpu_torch.ops.cuda import build


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


@build.counted
def nn_distance_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """K1: (dist1 [b,n], idx1 [b,n] i32, dist2 [b,m], idx2 [b,m] i32).

    Two launches, one per direction."""
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    lib = build.load_library()
    opts = dict(device=xyz1.device)
    d1 = torch.empty((b, n), dtype=torch.float32, **opts)
    i1 = torch.empty((b, n), dtype=torch.int32, **opts)
    d2 = torch.empty((b, m), dtype=torch.float32, **opts)
    i2 = torch.empty((b, m), dtype=torch.int32, **opts)
    with torch.cuda.device(xyz1.device):
        stream = torch.cuda.current_stream().cuda_stream
        for q, o, d, i, nq, no in ((xyz1, xyz2, d1, i1, n, m),
                                   (xyz2, xyz1, d2, i2, m, n)):
            build.check_launch(
                lib.gat_nn_distance(_ptr(q), _ptr(o), _ptr(d), _ptr(i), b, nq,
                                    no, stream),
                "nn_distance",
            )
            nn_distance_cuda.launches += 1
    return d1, i1, d2, i2


@build.counted
def nn_distance_values_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """K2: (dist1 [b,n], dist2 [b,m]) without the argmin. Two launches."""
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    lib = build.load_library()
    d1 = torch.empty((b, n), dtype=torch.float32, device=xyz1.device)
    d2 = torch.empty((b, m), dtype=torch.float32, device=xyz1.device)
    with torch.cuda.device(xyz1.device):
        stream = torch.cuda.current_stream().cuda_stream
        for q, o, d, nq, no in ((xyz1, xyz2, d1, n, m), (xyz2, xyz1, d2, m, n)):
            build.check_launch(
                lib.gat_nn_distance_values(_ptr(q), _ptr(o), _ptr(d), b, nq,
                                           no, stream),
                "nn_distance_values",
            )
            nn_distance_values_cuda.launches += 1
    return d1, d2


@build.counted
def chamfer_grad1_cuda(xyz1, xyz2, idx1, idx2, g1, g2) -> torch.Tensor:
    """K3: gradient of sum(g1*dist1) + sum(g2*dist2) wrt xyz1, [b, n, 3]."""
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
            lib.gat_chamfer_grad1(
                _ptr(xyz1), _ptr(xyz2), _ptr(idx1), _ptr(idx2), _ptr(g1),
                _ptr(g2), _ptr(out), b, n, m,
                torch.cuda.current_stream().cuda_stream,
            ),
            "chamfer_grad1",
        )
        chamfer_grad1_cuda.launches += 1
    return out


WRAPPERS = (nn_distance_cuda, nn_distance_values_cuda, chamfer_grad1_cuda)


def reset_launch_counts() -> None:
    build.reset_launch_counts(WRAPPERS)


def launch_counts() -> dict[str, int]:
    return build.launch_counts(WRAPPERS)
