"""The program's spans and counters (``utils/profiling.py``) in the attack
loop, the chamfer op and the victim's training, on the CPU.

Without a profiler no span enters ``torch.profiler.record_function``; under
one, the exported trace holds each span where the program opens it, nested
in its parent; the profiler changes no output bit; the counters count the
work of each call.
"""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geometric_adv_tpu_torch.attack.core import attack_batch
from geometric_adv_tpu_torch.data.datasets import PointCloudDataSet
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE, init_weights
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.train.trainer import AETrainer
from geometric_adv_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
N_POINTS, PAIRS, ITERS, THRESH = 32, 3, 3, 2
TRAIN = dict(n_input=[64, 3], bneck_size=16, encoder_filters=[16, 32, 16],
             decoder_sizes=[32, 32], batch_size=8, learning_rate=0.005,
             training_epochs=1, saver_step=None, held_out_step=None)
# attack_batch's keywords per case; "frozen" refreshes at t = 0 and 2
ATTACKS = {
    "exact": dict(dist_weights=[0.5, 2.0]),
    "max_point": dict(dist_weights=[1.0], max_point_dist_weight=0.5),
    "frozen": dict(dist_weights=[1.0], chamfer_refresh=2),
}


def victim():
    model = PointNetAE(n_points=N_POINTS, bneck_size=8, encoder_filters=[16, 8],
                       decoder_sizes=[16, 16])
    init_weights(model, torch.Generator().manual_seed(0))
    return model.eval().requires_grad_(False)


def run_attack(case):
    model = victim()
    rng = np.random.RandomState(3)
    x, gt = (torch.tensor(rng.rand(PAIRS, N_POINTS, 3).astype(np.float32))
             for _ in range(2))
    with torch.no_grad():
        tz = model.encode(gt)
    ref = torch.tensor(rng.rand(PAIRS).astype(np.float32) + 0.5)
    return attack_batch(model.encode, model.decode, x, tz, gt, ref,
                        num_iterations=ITERS, num_iterations_thresh=THRESH,
                        **ATTACKS[case])


def run_training():
    """A trainer after two steps, one epoch of two batches of 8."""
    rng = np.random.RandomState(5)
    clouds = rng.rand(2 * TRAIN["batch_size"], 64, 3).astype(np.float32)
    trainer = AETrainer(Configuration(**TRAIN), "cpu")
    trainer.train(PointCloudDataSet(clouds, init_shuffle=False))
    return trainer


def traced(fn, tmp_path):
    """(fn's result, the spans of its CPU trace: [(name, start, end)])."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, [(n, s, e) for n, s, e in sorted(spans, key=lambda t: t[1])]


def inside(spans, parent):
    """The spans within ``parent``'s interval, in start order."""
    _, s0, e0 = parent
    return [sp for sp in spans if sp is not parent and s0 <= sp[1] and sp[2] <= e0]


@pytest.fixture
def fresh_counters(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTS", {})


def test_span_is_one_shared_no_op_without_a_profiler():
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("a") is not profiling.span("b")
    assert profiling.span("a") is profiling.span("b")


# Spans left open across the end of one profiler session and the start of
# the next, as a profiler started and stopped in the middle of the program's
# call leaves them: ended under the second session, a plain record_function
# corrupts the memory of the first and the process dies.
STRADDLE = """
import gc, sys, torch
from geometric_adv_tpu_torch.utils import profiling
open_span = profiling.span if sys.argv[1] == "span" else torch.profiler.record_function
cpu = [torch.profiler.ProfilerActivity.CPU]
for _ in range(30):
    first = torch.profiler.profile(activities=cpu)
    first.start()
    held = [open_span(f"s{k}") for k in range(3)]
    for s in held:
        s.__enter__()
        w = torch.randn(64, 64, requires_grad=True)
        (w @ w).sum().backward()
    first.stop()
    second = torch.profiler.profile(activities=cpu)
    second.start()
    for s in reversed(held):
        s.__exit__(None, None, None)
    for _ in range(20):
        w = torch.randn(64, 64, requires_grad=True)
        (w @ w).sum().backward()
    second.stop()
    del held, first, second
    gc.collect()
    stranded = len(profiling._STRANDED)
    with profiling.span("after"):
        pass
    assert stranded == (3 if sys.argv[1] == "span" else 0) and not profiling._STRANDED
print("done")
"""


def test_a_span_left_open_into_the_next_session_ends_after_it():
    out = subprocess.run([sys.executable, "-c", STRADDLE, "span"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "done", out.stderr[-2000:]


@pytest.mark.parametrize("run", [*ATTACKS, "train"])
def test_no_record_function_without_a_profiler(monkeypatch, run):
    def refuse(*_args, **_kw):
        raise AssertionError("record_function entered with no profiler running")

    # the name ``span`` enters (torch's optimizers enter their own
    # through torch.autograd.profiler, whatever the profiler's state)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if run == "train":
        run_training()
    else:
        run_attack(run)


@pytest.mark.parametrize("case", list(ATTACKS))
def test_attack_spans_in_the_trace(tmp_path, case):
    _, spans = traced(lambda: run_attack(case), tmp_path)
    names = Counter(n for n, _, _ in spans)
    steps = ITERS + 1  # t = 0..ITERS; the last only records
    assert names["attack.call"] == 1
    assert names["attack.iter"] == steps
    assert names["attack.forward"] == steps
    assert names["attack.backward"] == names["attack.adam"] == ITERS
    assert names["attack.track"] == steps - THRESH
    assert names["attack.refresh"] == (2 if case == "frozen" else 0)
    # the frozen forward is elementwise; the others run two chamfers a step
    chamfers = 0 if case == "frozen" else 2 * steps
    assert names["chamfer.forward"] == chamfers
    assert names["chamfer.backward"] == (0 if case == "frozen" else 2 * ITERS)

    (call,) = [sp for sp in spans if sp[0] == "attack.call"]
    iters = [sp for sp in spans if sp[0] == "attack.iter"]
    assert all(sp in inside(spans, call) for sp in iters)
    for t, it in enumerate(iters):
        kids = [n for n, _, _ in inside(spans, it) if n.startswith("attack.")]
        want = (["attack.refresh"] if case == "frozen" and t % 2 == 0 else [])
        want += ["attack.forward"]
        want += [] if t == ITERS else ["attack.backward"]
        want += ["attack.track"] if t >= THRESH else []
        want += [] if t == ITERS else ["attack.adam"]
        assert kids == want, t
        for sp in inside(spans, it):
            if sp[0] == "chamfer.forward":
                assert any(p[0] == "attack.forward" and sp in inside(spans, p)
                           for p in inside(spans, it))
            if sp[0] == "chamfer.backward":
                assert any(p[0] == "attack.backward" and sp in inside(spans, p)
                           for p in inside(spans, it))
    # the chamfer span never holds itself
    for sp in spans:
        if sp[0] == "chamfer.forward":
            assert not [c for c in inside(spans, sp) if c[0] == "chamfer.forward"]


def test_training_spans_in_the_trace(tmp_path):
    _, spans = traced(run_training, tmp_path)
    names = Counter(n for n, _, _ in spans if n.startswith("train."))
    assert names == {"train.epoch": 1, "train.batch": 2, "train.step": 2,
                     "train.forward": 2, "train.loss": 2, "train.backward": 2,
                     "train.optimizer": 2}
    (epoch,) = [sp for sp in spans if sp[0] == "train.epoch"]
    steps = [sp for sp in spans if sp[0] == "train.step"]
    batches = [sp for sp in spans if sp[0] == "train.batch"]
    assert all(sp in inside(spans, epoch) for sp in steps + batches)
    for batch, step in zip(batches, steps):
        assert batch[2] <= step[1]  # a batch is gathered before its step
        kids = [n for n, _, _ in inside(spans, step) if n.startswith("train.")]
        assert kids == ["train.forward", "train.loss", "train.backward",
                        "train.optimizer"]
        (loss,) = [sp for sp in inside(spans, step) if sp[0] == "train.loss"]
        assert [n for n, _, _ in inside(spans, loss)] == ["chamfer.forward"]
        (back,) = [sp for sp in inside(spans, step) if sp[0] == "train.backward"]
        assert "chamfer.backward" in [n for n, _, _ in inside(spans, back)]


@pytest.mark.parametrize("case", list(ATTACKS))
def test_the_profiler_changes_no_attack_output(tmp_path, case):
    plain = run_attack(case)
    under, _ = traced(lambda: run_attack(case), tmp_path)
    for a, b in zip(plain, under):
        assert np.array_equal(a, b)


def test_the_profiler_changes_no_trained_parameter(tmp_path):
    plain = run_training()
    under, _ = traced(run_training, tmp_path)
    for (k, a), (_, b) in zip(plain.model.state_dict().items(),
                              under.model.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(plain.optimizer.state.values(), under.optimizer.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])


@pytest.mark.parametrize("case", list(ATTACKS))
def test_attack_counters(fresh_counters, case):
    run_attack(case)
    rows = PAIRS * len(ATTACKS[case]["dist_weights"])
    want = {"attack.pair_iters": rows * ITERS}
    if case == "frozen":
        want["attack.refreshes"] = 2
    assert profiling.counters() == want
    run_attack(case)
    assert profiling.counters() == {k: 2 * v for k, v in want.items()}


def test_training_counters(fresh_counters):
    trainer = run_training()
    bs = TRAIN["batch_size"]
    assert profiling.counters() == {"train.steps": 2, "train.samples": 2 * bs}
    trainer.partial_fit(np.random.RandomState(1).rand(5, 64, 3))
    assert profiling.counters() == {"train.steps": 3, "train.samples": 2 * bs + 5}
    profiling.reset_counters()
    assert profiling.counters() == {}
