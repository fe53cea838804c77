"""Device traces (``geometric_adv_tpu/utils/profiling.py``'s ``trace``).

The JAX package traces through ``jax.profiler``; here ``torch.profiler``
records the host's operators and, on a CUDA device, the kernels on the
card, and writes one Chrome trace (open it in ui.perfetto.dev or
chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp

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
