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
count per sweep. K7 skips, exactly, the terms whose kernel value
``exp(level * d2)`` is +0 (``EXP_UNDERFLOW``). The plain PyTorch version is
``geometric_adv_tpu_torch/ops/emd.py::emd_sweep_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from geometric_adv_tpu_torch.ops.cuda import build

BLOCK_MAX_POINTS = 1024  # K6 keeps one cloud pair in one block
# The smallest float32 t with exp(t) > 0: below it exp gives exactly +0 (on
# the host, tests/test_torch_ops_emd_skip.py; with the kernels' expf on the
# card, numerics_scan). K7 skips the terms whose level * d2 is below it
# (kExpUnderflow in csrc/emd_sweep.cu).
EXP_UNDERFLOW = float.fromhex("-0x1.9fe368p+6")  # -103.97207641601562


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
                         want_g1: bool, want_g2: bool, *,
                         skip_counts: torch.Tensor | None = None):
    """K7: a column and a row launch per round over blocks of 128 points;
    any n, m.

    ``skip_counts`` (int64 [len(levels), 3] on the card, for
    ``chip_smoke.py``'s skip shares) adds the (warp, element) pairs skipped
    at each level in the column, row closing and row opening sweeps."""
    b, n, m = build.cloud_sizes(xyz1, xyz2)
    if skip_counts is not None:
        build.check(skip_counts, "skip_counts", torch.int64, (len(levels), 3),
                    xyz1.device)
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
                _ptr(skip_counts),
                torch.cuda.current_stream().cuda_stream,
            ),
            "emd_sweep_tiled",
        )
        emd_sweep_tiled_cuda.launches += 1
    return cost, g1, g2


def numerics_scan(device) -> dict:
    """Check on the card the numerics K7 rests on (``numerics_scan`` in
    ``csrc/emd_sweep.cu``): over every float32 t in [-110, -100],
    ``expf_mismatches`` counts the t where "expf(t) is +0" differs from
    "t < EXP_UNDERFLOW", beside the most negative t with expf(t) > 0 and the
    least negative t with expf(t) == +0; over every float32 x in
    [1e-20, FLT_MAX], ``sqrt_mismatches`` counts the x where K7's square
    root from the gradient's rsqrt differs from sqrtf in any bit."""
    lib = build.load_library()
    # unsigned on the card; -1 is 0xffffffff
    out = torch.tensor([0, 0, -1, 0], dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        build.check_launch(
            lib.gat_emd_numerics_scan(_ptr(out), torch.cuda.current_stream().cuda_stream),
            "emd_numerics_scan",
        )
    out = out.cpu()
    positive, zero = out[1:3].view(torch.float32).tolist()
    return {"expf_mismatches": int(out[0]), "most_negative_positive": positive,
            "least_negative_zero": zero, "sqrt_mismatches": int(out[3])}


WRAPPERS = (emd_sweep_block_cuda, emd_sweep_tiled_cuda)


def reset_launch_counts() -> None:
    build.reset_launch_counts(WRAPPERS)


def launch_counts() -> dict[str, int]:
    return build.launch_counts(WRAPPERS)
