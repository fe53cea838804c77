"""The reductions the per-layer metrics share; each metric's own file under
``metrics/`` picks one and the entry or kernel it reads.

A reader takes the run's record (``core/harness.py``: the window's work and
seconds, the shapes, and with ``--trace 1`` the trace of ``core/trace.py``)
and returns a number, or None where the record holds nothing for it.
"""

from __future__ import annotations

import re

from h100_bench.core.peaks import FP32_PEAK, kernel_bound


def idle_pct(record, entry: str):
    """The share of the untraced window in which no device operation ran:
    the device-only trace's busy time a step against the window's time a
    step (its units over the units a step). The trace's own length is left
    out: under the profiler the host runs a step slower by 0-4 ms from run
    to run, while the busy time a step stays put."""
    trace, w = record.get("trace"), record["window"]
    if record["entry"] != entry or not trace or not trace["steps"] or not w["units"]:
        return None
    busy = trace["busy_s"] / trace["steps"]
    step = w["seconds"] * record["shapes"]["units_per_step"] / w["units"]
    return 100.0 * (1.0 - busy / step)


def mfu(record, entry: str):
    """The configuration's operations for the window's work over its time
    (untraced), as a share of the FP32 peak."""
    w = record["window"]
    if record["entry"] != entry or w["seconds"] <= 0:
        return None
    return 100.0 * w["flops_per_unit"] * w["units"] / w["seconds"] / FP32_PEAK


def launches(record, entry: str):
    """Kernels launched in the traced stretch per step or iteration in it."""
    trace = record.get("trace")
    if record["entry"] != entry or not trace or not trace["steps"]:
        return None
    return len(trace["kernels"]) / trace["steps"]


def roofline_pct(record, entry: str, kernel: str, bound_name: str):
    """The kernel's least time at the cell's chamfer shape over its mean
    time per launch in the traced stretch; None where it did not launch."""
    trace = record.get("trace")
    if record["entry"] != entry or not trace:
        return None
    pat = re.compile(r"\b" + re.escape(kernel))
    times = [d for name, _s, d in trace["kernels"] if pat.search(name)]
    if not times:
        return None
    b, n, m = record["shapes"]["chamfer"]
    bound_ms = kernel_bound(bound_name, b, n, m)[0]
    return 100.0 * bound_ms / (sum(times) / len(times) / 1e3)
