"""ctypes wrappers of the hand-written EMD auction-sweep kernels K6 and K7
(``csrc/emd_sweep.cu``).

Both take clouds ``[b, n, 3]`` and ``[b, m, 3]`` (f32, contiguous, one card),
the level schedule, and ``want_g1`` / ``want_g2``; they return
``(cost [b], g1 [b, n, 3] or None, g2 [b, m, 3] or None)``. The cost is
computed the same way whatever gradients are asked for. The numerics are the
plain version's: float32 planes and state, float64 plane sums and state
updates (see ``csrc/emd_sweep.cu``). The shared library
is built and loaded by ``ops/cuda/build.py``; each wrapper launches on the
current CUDA stream without synchronising and adds one to its ``launches``
count per sweep. The plain PyTorch version is
``geometric_adv_tpu_torch/ops/emd.py::emd_sweep_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from geometric_adv_tpu_torch.ops.cuda import build

BLOCK_MAX_POINTS = 1024  # K6 keeps one cloud pair in one block


def multipliers(n: int, m: int) -> tuple[float, float]:
    """Initial (remain_l, remain_r): the integer multipliers of the
    reference (tf_approxmatch_g.cu:3-10; C integer division)."""
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def _outputs(b, n, m, device, want_g1, want_g2):
    cost = torch.empty((b,), dtype=torch.float32, device=device)
    g1 = torch.empty((b, n, 3), dtype=torch.float32, device=device) if want_g1 else None
    g2 = torch.empty((b, m, 3), dtype=torch.float32, device=device) if want_g2 else None
    return cost, g1, g2


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _levels(levels) -> tuple[ctypes.Array, int]:
    return (ctypes.c_float * len(levels))(*levels), len(levels)


@build.counted
def emd_sweep_block_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor, levels,
                         want_g1: bool, want_g2: bool):
    """K6: one block per cloud pair, all rounds in one launch; n, m <= 1024."""
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    if max(n, m) > BLOCK_MAX_POINTS:
        raise ValueError(f"emd_sweep_block_cuda takes n, m <= {BLOCK_MAX_POINTS}, "
                         f"got n={n}, m={m}")
    lib = build.load_library()
    cost, g1, g2 = _outputs(b, n, m, xyz1.device, want_g1, want_g2)
    lv, n_levels = _levels(levels)
    with torch.cuda.device(xyz1.device):
        build.check_launch(
            lib.gat_emd_sweep_block(
                _ptr(xyz1), _ptr(xyz2), _ptr(cost), _ptr(g1), _ptr(g2), b, n,
                m, *multipliers(n, m), lv, n_levels,
                torch.cuda.current_stream().cuda_stream,
            ),
            "emd_sweep_block",
        )
        emd_sweep_block_cuda.launches += 1
    return cost, g1, g2


@build.counted
def emd_sweep_tiled_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor, levels,
                         want_g1: bool, want_g2: bool):
    """K7: three launches per round over blocks of 256 points; any n, m."""
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    lib = build.load_library()
    cost, g1, g2 = _outputs(b, n, m, xyz1.device, want_g1, want_g2)
    # remain_l, ratio_l [b, n] and remain_r, ratio_r [b, m]; the per-row
    # cost [b, n] in float64
    state = torch.empty((b * (2 * n + 2 * m),), dtype=torch.float32,
                        device=xyz1.device)
    cost_row = torch.empty((b * n,), dtype=torch.float64, device=xyz1.device)
    lv, n_levels = _levels(levels)
    with torch.cuda.device(xyz1.device):
        build.check_launch(
            lib.gat_emd_sweep_tiled(
                _ptr(xyz1), _ptr(xyz2), _ptr(state), _ptr(cost_row), _ptr(cost),
                _ptr(g1), _ptr(g2), b, n, m, *multipliers(n, m), lv, n_levels,
                torch.cuda.current_stream().cuda_stream,
            ),
            "emd_sweep_tiled",
        )
        emd_sweep_tiled_cuda.launches += 1
    return cost, g1, g2


WRAPPERS = (emd_sweep_block_cuda, emd_sweep_tiled_cuda)


def reset_launch_counts() -> None:
    build.reset_launch_counts(WRAPPERS)


def launch_counts() -> dict[str, int]:
    return build.launch_counts(WRAPPERS)
