"""CPU tests of the reduction of a traced stretch to the program's spans
(``h100_bench/core/span_readers.py``) and of ``span_split.py``.

    python -m pytest h100_bench/tests -q

A made-up trace puts kernels down to spans through their launches'
correlation ids across two threads, leaves out spans cut by the window's
edges, and keeps ``gpu_user_annotation`` out of the busy time; a record
without spans (a program that opens none) reads None; the tool runs a cell
at a small size on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import span_split  # noqa: E402
from h100_bench.core import harness, span_readers  # noqa: E402
from h100_bench.core.trace import reduce_device  # noqa: E402


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def kernel(corr, ts, dur):
    return ev("kernel", f"k{corr}", ts, dur, tid=7, correlation=corr)


def launch(corr, ts, tid=1):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 2.0, tid=tid, correlation=corr)


# Two whole iterations (100-200, 200-300) inside the window (95-405) and a
# third cut by its end; the backward's launches come from another thread
# (tid 2) while the main thread waits in attack.backward. Device times run
# late of their launches, as a full queue makes them.
EVENTS = [
    ev("user_annotation", "bench_window", 95.0, 310.0),
    ev("user_annotation", "attack.iter", 40.0, 59.0),  # begins before the window
    ev("user_annotation", "attack.iter", 100.0, 100.0),
    ev("user_annotation", "attack.forward", 101.0, 40.0),
    ev("user_annotation", "chamfer.forward", 120.0, 10.0),
    ev("user_annotation", "attack.backward", 150.0, 30.0),
    ev("user_annotation", "chamfer.backward", 155.0, 5.0, tid=2),
    ev("user_annotation", "attack.adam", 185.0, 10.0),
    ev("user_annotation", "attack.iter", 200.0, 100.0),
    ev("user_annotation", "attack.forward", 201.0, 40.0),
    ev("user_annotation", "attack.adam", 285.0, 10.0),
    ev("user_annotation", "attack.iter", 350.0, 100.0),  # ends after the window
    ev("user_annotation", "attack.forward", 351.0, 60.0),
    ev("gpu_user_annotation", "attack.iter", 100.0, 400.0, tid=7),
    # iteration 1: model 1 + 2 ms, chamfer 4 + 8 ms, adam 16 ms, glue 32 ms
    launch(1, 105.0), kernel(1, 400.0, 1000.0),
    launch(2, 122.0), kernel(2, 1400.0, 4000.0),
    launch(3, 152.0, tid=2), kernel(3, 5400.0, 2000.0),
    launch(4, 157.0, tid=2), kernel(4, 7400.0, 8000.0),
    launch(5, 190.0), kernel(5, 15400.0, 16000.0),
    launch(6, 197.0), kernel(6, 31400.0, 32000.0),
    # iteration 2: model 64 ms, adam 128 ms
    launch(7, 210.0), kernel(7, 63400.0, 64000.0),
    launch(8, 290.0), kernel(8, 127400.0, 128000.0),
    # outside every whole iteration: before, in the cut one, and unmatched
    launch(9, 60.0), kernel(9, 300000.0, 1000.0),
    launch(10, 360.0), kernel(10, 301000.0, 1000.0),
    kernel(11, 302000.0, 1000.0),
]


def test_kernels_go_to_the_spans_of_their_launch_across_threads():
    spans = span_readers.reduce_spans(EVENTS)
    assert spans["counts"] == {"attack.iter": 2, "attack.forward": 2, "attack.adam": 2,
                               "chamfer.forward": 1, "attack.backward": 1,
                               "chamfer.backward": 1}
    assert spans["sets"] == pytest.approx({
        "attack.iter|attack.forward": 1.0 + 64.0,
        "attack.iter|attack.forward|chamfer.forward": 4.0,
        "attack.iter|attack.backward": 2.0,
        "attack.iter|attack.backward|chamfer.backward": 8.0,
        "attack.iter|attack.adam": 16.0 + 128.0,
        "attack.iter": 32.0,
    })
    assert spans["device_ms"]["attack.iter"] == pytest.approx(255.0)
    assert spans["device_ms"]["chamfer.backward"] == pytest.approx(8.0)
    record = {"entry": "attack", "trace": {"spans": spans}}
    read = {name: span_readers.reading(record, name) for name in span_readers.READINGS}
    assert read["model_device_ms_per_iter.attack"] == pytest.approx((1 + 64 + 2) / 2)
    assert read["chamfer_device_ms_per_iter.attack"] == pytest.approx((4 + 8) / 2)
    assert read["loop_device_ms_per_iter.attack"] == pytest.approx((16 + 128) / 2)
    assert read["model_device_ms_per_step.victim_train"] is None  # another entry
    assert span_readers.unattributed_pct(record, "attack", "attack.iter") == \
        pytest.approx(100 * 32 / 255)


def test_spans_cut_by_the_window_are_left_out():
    cut = [e for e in EVENTS if not (e["name"] == "attack.iter" and e["ts"] == 100.0)]
    spans = span_readers.reduce_spans(cut)
    assert spans["counts"]["attack.iter"] == 1
    # iteration 1's launches now lie in no whole step: only iteration 2's count
    assert sum(spans["sets"].values()) == pytest.approx(64.0 + 128.0)
    with pytest.raises(RuntimeError):
        span_readers.reduce_spans([e for e in EVENTS if e["name"] != "bench_window"])


def test_busy_time_leaves_out_gpu_user_annotations():
    t = reduce_device(EVENTS, 1.0)
    kernels = [e for e in EVENTS if e["cat"] == "kernel"]
    assert len(t["kernels"]) == len(kernels)
    assert t["busy_s"] == pytest.approx(sum(e["dur"] for e in kernels) * 1e-6)


@pytest.mark.parametrize("name", sorted(span_readers.READINGS))
def test_a_record_without_spans_reads_none(name):
    """The parent commit's program opens no span: its records read None."""
    entry = span_readers.READINGS[name][0]
    for record in ({"entry": entry, "window": {"seconds": 1.0}},
                   {"entry": entry, "trace": {"steps": 3}},
                   {"entry": entry, "trace": {"spans": {"counts": {}, "sets": {},
                                                        "device_ms": {}}}}):
        assert span_readers.reading(record, name) is None


@pytest.mark.parametrize("cell, step", [("attack_victim2048_b500", "attack.iter"),
                                        ("train_victim2048_b50", "train.step")])
def test_the_tool_runs_a_small_cell(cell, step):
    """On the CPU the trace holds spans but no kernel; the counters move by
    the window call's units."""
    small = harness.cell_from_files(cell, 2**31 + 7)
    small.config["n_points"] = 64
    if "attack" in small.config:
        small.config["attack"].update(num_iterations=20, num_iterations_thresh=16)
    small.traffic.update({k: v for k, v in {
        "pairs_per_call": 4, "check_pairs_per_call": 3, "bn_calibration_clouds": 16,
        "train_clouds": 160, "epochs_per_call": 3}.items() if k in small.traffic})
    small.workload.update(trace_host=[0, 4], trace_device=[4, 6])
    small.device = torch.device("cpu")
    record = span_split.split(small)
    assert record["trace"]["spans"]["counts"][step] >= 2
    counted = record["counter_deltas"]
    assert counted[{"attack.iter": "attack.pair_iters",
                    "train.step": "train.samples"}[step]] == record["window_call_units"]
    assert all(v == 0.0 for v in record["readings"].values() if v is not None)
    assert span_split.lines(record)[0].startswith("spans: ")
