"""ctypes wrappers of the fused train-mode batch norm + ReLU kernels
(``csrc/bn_relu.cu``): one launch forward, two backward.

``bn_relu_forward_cuda(x [R, C], mean, mean_sq, weight, bias, running_mean,
running_var, eps, momentum)`` returns ``(y [R, C], stats [5, C])`` from the
batch moments ``mean`` and ``mean_sq`` [C] and updates the running
statistics in place; ``bn_relu_backward_cuda(dy, x, weight, bias, stats)``
returns ``(dx, dweight, dbias)``. All f32, contiguous, on one card. The
plain PyTorch version, and the autograd function that routes between the
two, are in ``geometric_adv_tpu_torch/ops/bn_relu.py``.

The shared library is built and loaded by ``ops/cuda/build.py``. Each
wrapper launches on the current CUDA stream without synchronising and adds
one to its ``launches`` count per call (the backward's is two kernel
launches). The backward keeps its scratch per device (``_scratch``): the sums
launch's partial rows, the counters on which their last blocks meet
(zeroed once, left at 0 by every launch) and the backward's coefficients
of dx; so calls run one after another on one stream. Scratch outgrown by a
larger call is kept, not freed: a CUDA graph captured over the backward
(``models/body_graph.py``) holds its pointers.
"""

from __future__ import annotations

import functools

import torch

from geometric_adv_tpu_torch.ops.cuda import build

STATS = ("mean", "var", "r", "a", "flag")  # the rows of ``stats``
_LANES = 8  # columns a block covers (kLanes in csrc/bn_relu.cu)
_SUMS_BLOCKS_PER_SM = 4  # kSumsBlocksPerSm
_scratch_by_device: dict[torch.device, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
_outgrown: list = []  # scratch a larger call replaced, kept for the graphs that hold it


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """4 channels a column (float4 loads) where they divide C and every
    row tensor is 16-byte aligned, else 1."""
    return 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _scratch(device: torch.device, c: int, vec: int):
    """The device's scratch for a call over C channels, grown on demand:
    (partials, their capacity in doubles, counters, their count, coef
    [2, C]). A sums launch has at most ``sms * 4 + column chunks`` blocks
    of one partial row each; the counters are zeroed once and left at 0 by
    every launch, and calls on one stream use the scratch one after
    another."""
    chunks = -(-(c // vec) // _LANES)
    cap = (_sms(device) * _SUMS_BLOCKS_PER_SM + chunks) * 2 * _LANES * 4
    have = _scratch_by_device.get(device)
    if have is None or have[0].numel() < cap or have[1].numel() < chunks \
            or have[2].numel() < 2 * c:
        if have is not None:
            _outgrown.append(have)
        have = (torch.empty(cap, dtype=torch.float64, device=device),
                torch.zeros(max(chunks, 256), dtype=torch.int32, device=device),
                torch.empty(2 * c, dtype=torch.float32, device=device))
        _scratch_by_device[device] = have
    partials, counters, coef = have
    return partials, partials.numel(), counters, counters.numel(), coef


def _check_rows(x: torch.Tensor, name: str) -> tuple[int, int]:
    if x.dim() != 2 or min(x.shape) == 0:
        raise ValueError(f"{name} must be a non-empty [rows, channels] tensor, "
                         f"got {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name} too large for int32 rows: {tuple(x.shape)}")
    build.check(x, name, torch.float32, tuple(x.shape), x.device)
    return x.shape


def _check_channels(c: int, device, **tensors) -> None:
    for name, t in tensors.items():
        build.check(t, name, torch.float32, (c,), device)


@build.counted
def bn_relu_forward_cuda(x: torch.Tensor, mean: torch.Tensor, mean_sq: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                         running_var: torch.Tensor, eps: float, momentum: float):
    """-> (y [R, C], stats [5, C]) from the batch moments; the running
    statistics updated in place as ``momentum * running + (1 - momentum) *
    batch``."""
    rows, c = _check_rows(x, "x")
    _check_channels(c, x.device, mean=mean, mean_sq=mean_sq, weight=weight, bias=bias,
                    running_mean=running_mean, running_var=running_var)
    lib = build.load_library()
    y = torch.empty_like(x)
    stats = torch.empty((len(STATS), c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        build.check_launch(
            lib.gat_bn_relu_forward(
                x.data_ptr(), mean.data_ptr(), mean_sq.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
                stats.data_ptr(), y.data_ptr(), rows, c, eps, momentum, 1.0 - momentum,
                _vec(c, x), _sms(x.device), torch.cuda.current_stream().cuda_stream,
            ),
            "bn_relu_forward",
        )
        bn_relu_forward_cuda.launches += 1
    return y, stats


@build.counted
def bn_relu_backward_cuda(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, stats: torch.Tensor):
    """-> (dx [R, C], dweight [C], dbias [C]) from the forward's x and
    stats."""
    rows, c = _check_rows(x, "x")
    build.check(dy, "dy", torch.float32, (rows, c), x.device)
    build.check(stats, "stats", torch.float32, (len(STATS), c), x.device)
    _check_channels(c, x.device, weight=weight, bias=bias)
    lib = build.load_library()
    vec = _vec(c, x, dy)
    dx = torch.empty_like(x)
    dweight, dbias = torch.empty((2, c), dtype=torch.float32, device=x.device)
    partials, cap, counters, n_counters, coef = _scratch(x.device, c, vec)
    with torch.cuda.device(x.device):
        build.check_launch(
            lib.gat_bn_relu_backward(
                dy.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                stats.data_ptr(), coef.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
                dx.data_ptr(), partials.data_ptr(), cap, counters.data_ptr(), n_counters,
                rows, c, vec, _sms(x.device), torch.cuda.current_stream().cuda_stream,
            ),
            "bn_relu_backward",
        )
        bn_relu_backward_cuda.launches += 1
    return dx, dweight, dbias


WRAPPERS = (bn_relu_forward_cuda, bn_relu_backward_cuda)


def reset_launch_counts() -> None:
    build.reset_launch_counts(WRAPPERS)


def launch_counts() -> dict[str, int]:
    return build.launch_counts(WRAPPERS)
