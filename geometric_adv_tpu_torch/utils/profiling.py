"""Device traces and timers (``geometric_adv_tpu/utils/profiling.py``).

The JAX package traces through ``jax.profiler``; here ``torch.profiler``
records the host's operators and, on a CUDA device, the kernels on the
card, and writes one Chrome trace (open it in ui.perfetto.dev or
chrome://tracing). ``ThroughputMeter`` is the JAX package's, line for line;
``log_compile_time`` times a first call, as the port compiles nothing.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device):
    """``with trace("/tmp/trace", device): step()`` writes
    ``log_dir/trace.json`` when the block ends, after the device's queue
    has drained."""
    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(osp.join(log_dir, TRACE_FILE))


class ThroughputMeter:
    """items/sec counter; the caller makes the device's work finish inside
    ``measure`` (``torch.cuda.synchronize()``, or reading the result).

    Usage:
        meter = ThroughputMeter("pair-iters")
        with meter.measure(n_items=batch * iters):
            out = attack_fn(...)
            torch.cuda.synchronize()
        print(meter)
    """

    def __init__(self, unit: str = "items"):
        self.unit = unit
        self.total_items = 0
        self.total_seconds = 0.0
        self.calls = 0

    @contextlib.contextmanager
    def measure(self, n_items: int):
        t0 = time.perf_counter()
        yield
        self.total_seconds += time.perf_counter() - t0
        self.total_items += n_items
        self.calls += 1

    @property
    def rate(self) -> float:
        return self.total_items / max(self.total_seconds, 1e-12)

    def __str__(self) -> str:
        return (
            f"{self.rate:,.0f} {self.unit}/s "
            f"({self.total_items} over {self.total_seconds:.2f}s, "
            f"{self.calls} calls)"
        )


def _on_card(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        tree = list(tree.values())
    return isinstance(tree, (list, tuple)) and any(_on_card(v) for v in tree)


def log_compile_time(fn, *args, label: str = "fn", **kwargs):
    """Time one call of ``fn(*args, **kwargs)`` and print it; returns ``fn``.

    The JAX function compiles ``fn`` ahead of time and reports that. The
    port compiles nothing at run time: a first call's extra cost is the
    kernel library's build and load and cuBLAS's set-up on its first GEMM.
    So this makes the first call, synchronising the card where its result
    lies there, and reports the call's whole time."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if _on_card(out):
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[profiling] {label}: first call {dt:.1f}s")
    return fn
