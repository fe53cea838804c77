"""One run of one cell: set-up, the measured window, the optional traced
stretch, the check against the plain reference, and the result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run finds its cell in ``BENCHMARK.json``, and the cell's configuration,
traffic mix and entry by name (``registry.py``). It needs as many CUDA
devices as the cell asks for and fails without them; it never falls back to
the CPU. The window calls the entry's program call again and again until
``--seconds`` have passed and takes the rate over all the calls and all the
time. With ``--trace 1`` a further call runs with the profiler over two
steady stretches of it (``trace.py``), and the per-layer metrics are read
from that trace and the window.
Then the peak device memory is read, the program's state is freed and the
reference judges what the program produced.

The run sets the float32 precision its configuration states before the
program's set-up and reads it again once the window has closed
(``precision.py``): a program that changed it departs from its
configuration, and the run is not correct. The reference computes at the
stated precision whatever the program left behind.

The last line of standard output is the result, one JSON object; the
compared numbers, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field

from h100_bench.core import precision, registry
from h100_bench.core.trace import ProfileCalls

# top-level module names that may not be loaded in a run (whole names: the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "geometric_adv_tpu")


@dataclass
class Cell:
    """What an entry is given: the cell's name, seed, configuration, traffic
    and workload files, and the device."""

    name: str
    seed: int
    config: dict
    traffic: dict
    workload: dict
    device: object = None
    info: dict = field(default_factory=dict)  # lines printed before the result


@dataclass
class Check:
    """A number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def card_report() -> str:
    """The card's name, power limit, clocks and temperature (nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available: {e}"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_from_files(name: str, seed: int, chips: int = 1) -> Cell:
    """The cell of the workload file ``name``, whether or not
    ``BENCHMARK.json`` runs it yet."""
    work = registry.workload(name)
    return Cell(name, seed, registry.config(work["config"]),
                registry.traffic(work["traffic"]), work, info={"chips": chips})


def load_cell(name: str, seed: int) -> tuple[Cell, dict]:
    """The cell ``BENCHMARK.json`` names, and the benchmark."""
    bench = registry.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cell_from_files(name, seed, entry["chips"])
    if (cell.workload["config"], cell.workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"workloads/{name}.json and BENCHMARK.json name "
                         "different configurations or traffic")
    return cell, bench


def window(entry, state, seconds: float) -> dict:
    """Call the program until ``seconds`` have passed; every call returns
    after its results reached the host, so the clock covers all the work."""
    units, ends = 0.0, []
    t0 = time.perf_counter()
    while True:
        units += entry.call(state)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            return {"units": units, "seconds": ends[-1], "calls": len(ends),
                    "call_s": [round(b - a, 4) for a, b in zip([0.0] + ends, ends)]}


def traced(entry, state, work: dict) -> dict:
    """One more program call with its ``trace_host`` and ``trace_device``
    stretches profiled (``core/trace.py``): the device stretch's record,
    with the host stretch's names of the idle gaps."""
    module = entry.trace_module(state)
    run = getattr(entry, "traced_call", entry.call)
    with ProfileCalls(module, {"host": tuple(work["trace_host"]),
                               "device": tuple(work["trace_device"])}) as pc:
        run(state)
    if set(pc.records) != {"host", "device"}:
        raise RuntimeError("the traced call ended before its stretches began")
    return dict(pc.records["device"], idle_gaps=pc.records["host"]["idle_gaps"])


def sync(device) -> None:
    import torch

    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


def execute(cell: Cell, bench: dict, seconds: float, trace_on: bool,
            t_start: float) -> tuple[dict, list, list]:
    """Run the cell on ``cell.device``; -> (the result object, the checks,
    the lines printed before it). A run on the CPU (the tests') reads no
    device memory and loads no kernel library."""
    import torch

    on_card = cell.device.type == "cuda"
    precision.apply(precision.stated(cell.config["tf32"]))
    lib_s = 0.0
    if on_card:
        from geometric_adv_tpu_torch.ops.cuda.build import load_library

        t_lib = time.perf_counter()
        load_library()
        lib_s = time.perf_counter() - t_lib
    entry = registry.module("entries", cell.workload["entry"])
    flops = registry.module("flops", cell.workload["config"])
    t_entry = time.perf_counter()
    state = entry.setup(cell)
    sync(cell.device)
    setup_s = time.perf_counter() - t_start
    cell.info["setup parts"] = (f"to the library {t_entry - t_start - lib_s:.3f} s, "
                                f"library {lib_s:.3f} s, the entry's set-up "
                                f"{setup_s - (t_entry - t_start):.3f} s")

    measured = window(entry, state, seconds)
    departed = precision.departures(cell.config["tf32"])
    cell.info["precision after the window"] = precision.read()
    e2e, layer_metrics = registry.cell_metrics(bench, cell.name)
    values = {cell.workload["rate_metric"]: measured["units"] / measured["seconds"],
              "setup_s": setup_s}
    record = {
        "cell": cell.name, "entry": cell.workload["entry"], "config": cell.config,
        "traffic": cell.traffic, "shapes": entry.shapes(state),
        "window": dict(measured, flops_per_unit=flops.per_unit(
            cell.workload["entry"], cell.config, cell.traffic)),
    }
    trace = None
    if trace_on:
        trace = record["trace"] = traced(entry, state, cell.workload)
    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0
    card = card_report() if on_card else "cpu"
    t_check = time.perf_counter()
    checks = entry.check(state)
    checks.append(Check("precision_departures", float(len(departed)), 0.0))
    if departed:
        cell.info["precision departed from the configuration"] = departed
    cell.info["check"] = f"{time.perf_counter() - t_check:.3f} s"
    del state

    metrics = {}
    for m in layer_metrics if trace_on else e2e:
        if trace_on:
            v = registry.module("metrics", m["name"]).read(record)
        else:
            v = values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
              "count": cell.info.get("chips", 1), "memory_peak_bytes": peak}
    # Units are whole (pair-iterations, samples); the result line wants integers.
    attempted, failed = int(round(measured["units"])), sum(not c.ok for c in checks)
    result = {"correct": all(c.ok for c in checks),
              "attempted": attempted, "failed": min(failed, attempted),
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"], device["window_s"] = trace["busy_s"], trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}

    lines = [f"card: {card}",
             f"setup: {setup_s:.3f} s (kernel library {lib_s:.3f} s); window: "
             f"{measured['calls']} calls, {measured['units']:.0f} {entry.UNIT} in "
             f"{measured['seconds']:.3f} s (calls of {measured['call_s']} s); "
             f"peak device memory {peak} bytes"]
    lines += [f"{key}: {val}" for key, val in cell.info.items()]
    if trace is not None:
        per_call = measured["seconds"] / measured["calls"]
        lines.append(f"trace: {trace['steps']} steps, {len(trace['kernels'])} kernels, "
                     f"busy {trace['busy_s']:.6f} of {trace['window_s']:.6f} s "
                     f"(device-only trace: {1e3 * trace['window_s'] / trace['steps']:.3f} ms "
                     f"a step; untraced, {per_call:.3f} s a call)")
    return result, checks, lines


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell, bench = load_cell(args.workload, args.seed)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.info["chips"]:
        print(f"{args.workload}: needs {cell.info['chips']} CUDA device(s), found "
              f"{found}; no result", file=sys.stderr)
        return 2
    cell.device = torch.device("cuda:0")
    result, checks, lines = execute(cell, bench, args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that a run may not load are loaded: {', '.join(bad)}; "
              "no result", file=sys.stderr)
        return 3
    print("\n".join(lines))
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
