"""The program's spans in a traced stretch: each kernel put down to the
spans open at its launch, and the per-layer readings taken from that.

The program opens spans while a profiler records
(``geometric_adv_tpu_torch/utils/profiling.py``): ``attack.iter`` and
``train.step`` around each iteration or step, and inside them the
phases (``attack.forward``, ``attack.backward``, ``attack.adam``,
``chamfer.forward``, ``train.optimizer``, ...). In a stretch that records
host and device (``trace.py``'s ``host`` stretch), a kernel event and the
runtime or driver call that launched it share a ``correlation`` id, so
each kernel has a launch time on the spans' clock. A launch belongs to
every span whose interval holds it, whatever the thread: the autograd
engine launches the backward's kernels from its own thread while the main
thread waits in ``attack.backward`` or ``train.backward``.

Only spans that begin and end inside the ``bench_window`` annotation
count (complete spans), and the readings count only the kernels launched
inside a complete step span (``STEPS``). A program without spans (an
older commit) gives an empty reduction, and every reader gives None.
"""

from __future__ import annotations

from collections import defaultdict

from h100_bench.core.trace import MARK

STEPS = ("attack.iter", "train.step")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _window(events):
    marks = [e for e in events if e.get("name") == MARK and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no bench_window annotation")
    w0 = float(marks[0]["ts"])
    return w0, w0 + float(marks[0]["dur"])


def reduce_spans(events: list) -> dict:
    """{counts: {name: complete spans}, device_ms: {name: ms of the kernels
    launched inside complete spans of that name}, sets: {"step|child|...":
    ms}} of a stretch's Chrome-trace events. ``sets`` holds the kernels
    launched inside a complete step span, keyed by the step's name and the
    names of the spans inside that step which hold the launch, sorted;
    a key of the step's name alone is time under no child span."""
    w0, w1 = _window(events)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") != MARK]
    spans = [sp for sp in spans if w0 <= sp[0] and sp[1] <= w1]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    kernels = [(launched[e["args"]["correlation"]], float(e.get("dur", 0.0)) * 1e-3)
               for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched]
    counts = defaultdict(int)
    for _s, _e, name in spans:
        counts[name] += 1
    # one sweep in time: span starts before launches before span ends at
    # the same instant, so a launch on a span's edge lies inside it
    sweep = sorted([(s, 0, i) for i, (s, _e, _n) in enumerate(spans)]
                   + [(e, 2, i) for i, (_s, e, _n) in enumerate(spans)]
                   + [(t, 1, ms) for t, ms in kernels])
    device_ms, sets = defaultdict(float), defaultdict(float)
    active = {}
    for _t, kind, val in sweep:
        if kind == 0:
            active[val] = spans[val]
        elif kind == 2:
            del active[val]
        else:
            for name in {n for _s, _e, n in active.values()}:
                device_ms[name] += val
            steps = [sp for sp in active.values() if sp[2] in STEPS]
            if not steps:
                continue
            s0, e0, step = max(steps)  # the innermost: the latest begun
            kids = sorted({n for s, e, n in active.values()
                           if s0 <= s and e <= e0 and (s, e, n) != (s0, e0, step)})
            sets["|".join([step] + kids)] += val
    return {"counts": dict(counts), "device_ms": dict(device_ms), "sets": dict(sets)}


def _spans(record, entry: str, step: str):
    trace = record.get("trace") or {}
    spans = trace.get("spans")
    if record.get("entry") != entry or not spans or not spans["counts"].get(step):
        return None
    return spans


def device_ms_per_step(record, entry: str, step: str, within, outside=()):
    """The device ms, per complete ``step`` span, of the kernels launched
    inside it and inside one of the spans ``within`` and none of
    ``outside``; None where the record holds no such step."""
    spans = _spans(record, entry, step)
    if spans is None:
        return None
    ms = 0.0
    for key, v in spans["sets"].items():
        head, *kids = key.split("|")
        if head == step and set(kids) & set(within) and not set(kids) & set(outside):
            ms += v
    return ms / spans["counts"][step]


def unattributed_pct(record, entry: str, step: str):
    """The share of the kernel time inside complete ``step`` spans that
    falls under no span inside the step."""
    spans = _spans(record, entry, step)
    if spans is None:
        return None
    total = sum(v for k, v in spans["sets"].items() if k.split("|")[0] == step)
    return 100.0 * spans["sets"].get(step, 0.0) / total if total else None


# The per-layer readings of the spans, each: (entry, step span, spans whose
# kernels count, spans whose kernels do not). The model's step leaves out
# the chamfer inside it in the attack; in training it holds it.
READINGS = {
    "model_device_ms_per_iter.attack": (
        "attack", "attack.iter", ("attack.forward", "attack.backward"),
        ("chamfer.forward", "chamfer.backward")),
    "chamfer_device_ms_per_iter.attack": (
        "attack", "attack.iter", ("chamfer.forward", "chamfer.backward"), ()),
    "loop_device_ms_per_iter.attack": (
        "attack", "attack.iter", ("attack.adam", "attack.track"), ()),
    "model_device_ms_per_step.victim_train": (
        "train_ae", "train.step", ("train.forward", "train.loss", "train.backward"), ()),
    "optimizer_device_ms_per_step.victim_train": (
        "train_ae", "train.step", ("train.optimizer",), ()),
}


def reading(record, name: str):
    """The reading ``name`` of ``READINGS`` from a run's record."""
    entry, step, within, outside = READINGS[name]
    return device_ms_per_step(record, entry, step, within, outside)
