"""The traced stretches of one program call: torch.profiler over steps or
iterations of the program's own call, and their reduction to a trace record.

``ProfileCalls`` counts the forwards of a module of the program (a forward
pre-hook) and profiles two stretches of them, each of whole steps or
iterations, the device synchronised at both ends of each:

- ``device``: the profiler records the device alone (CUDA activity, no host
  operations), so that the host runs nearly as fast as untraced. Busy time
  is the union of the kernel, copy and fill intervals (overlapping
  operations count once); the stretch's length is the host clock's from the
  synchronised start to the synchronised end, which hold every operation
  of the stretch between them. The busy time, the kernels (launches,
  rooflines) and the device operations that took most time come from here.
- ``host``: the profiler records host operations too, which slows the host,
  so it only names the idle gaps: each gap by the innermost host operation
  running at its middle, within a ``bench_window`` annotation.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
MARK = "bench_window"


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


class ProfileCalls:
    """Profile the forwards [start, stop) of ``module`` for each of
    ``stretches`` ({"device": (start, stop), "host": (start, stop)}, not
    overlapping) during the program's call, used as a context manager
    around it. ``records`` holds each stretch's reduction once it ended."""

    def __init__(self, module: torch.nn.Module, stretches: dict):
        self.module = module
        self.stretches = stretches
        self.calls = 0
        self.open = None  # (kind, profiler, annotation, start time, first forward)
        self.records = {}

    def _pre_hook(self, _module, _args):
        for kind, (_start, stop) in self.stretches.items():
            if self.calls == stop and self.open and self.open[0] == kind:
                self._end()
        for kind, (start, _stop) in self.stretches.items():
            if self.calls == start:
                self._begin(kind)
        self.calls += 1

    def _begin(self, kind: str):
        _sync()
        cuda = torch.cuda.is_available()
        acts = [] if kind == "device" and cuda else [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        mark = None
        if kind == "host":
            mark = torch.profiler.record_function(MARK)
            mark.__enter__()
        self.open = (kind, prof, mark, time.perf_counter(), self.calls)

    def _end(self):
        kind, prof, mark, t0, first = self.open
        self.open = None
        _sync()
        window_s = time.perf_counter() - t0
        if mark is not None:
            mark.__exit__(None, None, None)
        prof.stop()
        events = _events(prof)
        if kind == "device":
            rec = reduce_device(events, window_s)
        else:
            rec = reduce_host(events)
        rec["steps"] = self.calls - first
        self.records[kind] = rec

    def __enter__(self):
        self.handle = self.module.register_forward_pre_hook(self._pre_hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()
        if self.open is not None:  # the call ended inside a stretch
            self._end()
        return False


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _device_ops(events):
    """[(category, name, start_us, end_us)] of the device's operations."""
    return [(e["cat"], e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def reduce_device(events: list, window_s: float) -> dict:
    """{window_s, busy_s, kernels: [(name, start_us, dur_us)], device_ops}
    of a device-only stretch ``window_s`` long."""
    ops = _device_ops(events)
    busy_us, _ = _union([(s, e) for _c, _n, s, e in ops])
    kernels = [(n, s, e - s) for c, n, s, e in ops if c == "kernel"]
    by_name = defaultdict(float)
    for name, _s, d in kernels:
        by_name[name] += d * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy_us * 1e-6, "kernels": kernels,
            "device_ops": [[k, v] for k, v in top]}


def reduce_host(events: list) -> dict:
    """{idle_gaps}: the ``bench_window`` stretch's idle gaps of the device,
    each named by the innermost host operation at its middle."""
    marks = [e for e in events if e.get("name") == MARK and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no bench_window annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    clipped = [(max(s, w0), min(e, w1)) for _c, _n, s, e in _device_ops(events)]
    _, merged = _union([(s, e) for s, e in clipped if e > s])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") != MARK)
    gaps = []
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    named = defaultdict(float)
    active, nxt = [], 0  # host operations begun before the gap, in start order
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        while active and active[-1][1] < mid:  # ended: no later gap needs it
            active.pop()
        # the latest begun that still runs is the innermost
        inner = next((h for h in reversed(active) if h[1] >= mid), None)
        named["host: " + (inner[2] if inner else "python")] += (g1 - g0) * 1e-6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return {"idle_gaps": [[k, v] for k, v in idle]}
