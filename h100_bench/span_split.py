"""A cell's device time put down to the program's spans, and its counters.

    python3 h100_bench/span_split.py --workload <cell> --seed <n> [--out FILE]

Runs the cell's set-up and one window call, reading the program's counters
(``geometric_adv_tpu_torch/utils/profiling.py``) around it, then one call
traced as a ``--trace 1`` run traces it (``core/trace.py``), with the host
stretch's events also reduced to the spans (``core/span_readers.py``).
Prints the ``spans:`` line (the count and device ms of each complete span,
the in-step kernel time under no child span, the counters' deltas beside
the call's units), each reading of ``span_readers.READINGS`` and the busy
time a step of both stretches; ``--out`` keeps them as JSON. The
benchmark's runs do not run this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench.core import harness, precision, registry, span_readers, trace  # noqa: E402


@contextlib.contextmanager
def spans_kept():
    """``trace.reduce_host`` also reduces the host stretch to the spans."""
    plain = trace.reduce_host
    trace.reduce_host = lambda events: dict(plain(events),
                                            spans=span_readers.reduce_spans(events))
    try:
        yield
    finally:
        trace.reduce_host = plain


def split(cell) -> dict:
    """The record of one window call and one traced call of ``cell`` on
    ``cell.device``."""
    from geometric_adv_tpu_torch.utils.profiling import counters

    precision.apply(precision.stated(cell.config["tf32"]))
    entry = registry.module("entries", cell.workload["entry"])
    state = entry.setup(cell)
    before = counters()
    units = entry.call(state)
    deltas = {k: v - before.get(k, 0) for k, v in counters().items()}
    work = cell.workload
    with spans_kept(), trace.ProfileCalls(
            entry.trace_module(state), {"host": tuple(work["trace_host"]),
                                        "device": tuple(work["trace_device"])}) as pc:
        getattr(entry, "traced_call", entry.call)(state)
    host, device = pc.records["host"], pc.records["device"]
    record = {"cell": cell.name, "entry": work["entry"], "window_call_units": units,
              "counter_deltas": deltas,
              "trace": dict(device, idle_gaps=host["idle_gaps"], spans=host["spans"],
                            host_steps=host["steps"])}
    record["trace"].pop("kernels")
    record["readings"] = {name: span_readers.reading(record, name)
                          for name in span_readers.READINGS}
    step = next((s for s in span_readers.STEPS if host["spans"]["counts"].get(s)), None)
    record["unattributed_pct"] = (None if step is None else
                                  span_readers.unattributed_pct(record, work["entry"], step))
    return record


def lines(record) -> list:
    tr, sp = record["trace"], record["trace"]["spans"]
    per = {name: [n, round(sp["device_ms"].get(name, 0.0) / n, 6)]
           for name, n in sorted(sp["counts"].items())}
    out = [f"spans: {json.dumps(per)}; under no child span "
           f"{record['unattributed_pct']}%; counters {record['counter_deltas']} "
           f"beside the call's {record['window_call_units']} units"]
    out += [f"{name}: {value}" for name, value in record["readings"].items()
            if value is not None]
    if tr["steps"]:
        out.append(f"device-only stretch: busy {1e3 * tr['busy_s'] / tr['steps']:.6f} ms a "
                   f"step over {tr['steps']} steps")
    out.append(f"idle gaps: {tr['idle_gaps']}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    from geometric_adv_tpu_torch.ops.cuda.build import load_library

    load_library()
    cell = harness.cell_from_files(args.workload, args.seed)
    cell.device = torch.device("cuda:0")
    record = split(cell)
    print(f"card: {harness.card_report()}")
    print("\n".join(lines(record)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
