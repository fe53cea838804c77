"""Device traces and timers (``geometric_adv_tpu/utils/profiling.py``).

The JAX package traces through ``jax.profiler``; here ``torch.profiler``
records the host's operators and, on a CUDA device, the kernels on the
card, and writes one Chrome trace (open it in ui.perfetto.dev or
chrome://tracing). ``ThroughputMeter`` is the JAX package's, line for line;
``log_compile_time`` times a first call, as the port compiles nothing.

The program marks its phases with ``span(name)`` and counts its work with
``count(name, n)``. A span is recorded only while a torch profiler records
(``trace`` here, or any other ``torch.profiler.profile``): it then enters
``torch.profiler.record_function``, so the phase lands in the trace as a
``user_annotation`` on the clock of the CUDA runtime calls and the kernels,
and each kernel can be put down to the spans open at its launch. Otherwise
``span`` returns one shared no-op context and calls no torch op. Counters
are plain ints, always on; ``counters()`` reads them, ``reset_counters()``
zeroes them. Kernel launches are counted by the kernel wrappers
(``ops/cuda/build.py::counted``), not here.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import time

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"

_NO_SPAN = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}
# Profiler sessions begun in this process, counted where torch flags one
# as begun. A record_function begun under one session and ended under the
# next writes its end into the first session's event storage, which that
# session freed when it stopped (torch's kineto observer); the memory
# corruption ends the process later. So a span ends only under the session
# it began in; begun under an earlier one, it is kept here and ends once no
# profiler records, when its end writes nothing.
_SESSIONS = [0]
_STRANDED: list = []


def _count_session(begin=autograd_profiler._run_on_profiler_start):
    _SESSIONS[0] += 1
    begin()


autograd_profiler._run_on_profiler_start = _count_session


class _Span:
    """``torch.profiler.record_function(name)``, ended only under the
    profiler session it began in."""

    __slots__ = ("name", "session", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.session = _SESSIONS[0]
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        return self

    def __exit__(self, *exc):
        if autograd_profiler._is_profiler_enabled and self.session != _SESSIONS[0]:
            _STRANDED.append(self.record)
        else:
            self.record.__exit__(*exc)
        return False


def span(name: str):
    """``with span("attack.iter"): ...`` names the block in a profiler's
    trace while one records; a no-op otherwise."""
    # torch's own flag, set while any profiler records: the check costs
    # under a microsecond where entering record_function costs ~13 us
    if not autograd_profiler._is_profiler_enabled:
        if _STRANDED:
            _STRANDED.clear()  # no session runs: their ends write nothing
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; count once per call or epoch,
    where the work finishes."""
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """A copy of every counter counted since the last reset."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def trace(log_dir: str, device):
    """``with trace("/tmp/trace", device): step()`` writes
    ``log_dir/trace.json`` when the block ends, after the device's queue
    has drained; the program's spans are in it."""
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
