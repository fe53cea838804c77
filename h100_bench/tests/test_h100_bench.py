"""CPU tests of the benchmark's harness (``h100_bench/``); the card's test
skips here.

    python -m pytest h100_bench/tests -q

They parse every file the benchmark names, hold the operation counts and
the frozen kernel bounds to their hand counts, reduce a made-up trace, run
whole cells at a small size on the CPU (a new workload file picked up by
name; the planted faults each turning ``correct`` false), and check that
a run without a card fails and that nothing here loads JAX or the JAX
package.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.core import harness, peaks, registry  # noqa: E402
from h100_bench.core.trace import reduce_device, reduce_host  # noqa: E402

BENCH = registry.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
# every workload file, the cells BENCHMARK.json does not run yet among them
WORKLOADS = sorted(p.stem for p in (ROOT / "h100_bench/workloads").glob("*.json"))
ATTACK, VICTIM = "attack_victim2048_b500", "train_victim2048_b50"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_names_files_that_parse(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    work = registry.workload(cell)
    assert (work["config"], work["traffic"]) == (entry["config"], entry["traffic"])
    cfg = registry.config(work["config"])
    conf_entry = next(c for c in BENCH["configs"] if c["name"] == work["config"])
    assert (ROOT / conf_entry["file"]).is_file()
    assert sorted(cfg["reduced"]) == sorted(conf_entry["reduced"])
    registry.traffic(work["traffic"])
    mod = registry.module("entries", work["entry"])
    for fn in ("setup", "call", "check", "control", "trace_module", "shapes"):
        assert callable(getattr(mod, fn))
    assert registry.module("flops", work["config"]).per_unit(work["entry"], cfg, {}) > 0
    e2e, layer = registry.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert {"setup_s", work["rate_metric"]} <= names and layer
    assert all(m["moves"] in names for m in layer)


@pytest.mark.parametrize("metric", sorted(p.stem for p in (ROOT / "h100_bench/metrics").glob("*.py")))
def test_every_metric_has_a_reader(metric):
    reader = registry.module("metrics", metric)
    assert reader.read({"entry": "none", "window": {"seconds": 1.0}}) is None


@pytest.mark.parametrize("config, entry, unit_flops", [
    ("pointnet_ae_chamfer_2048", "attack", 830e6),
    ("pointnet_ae_chamfer_2048", "train_ae", 1.16e9),
])
def test_flops_match_the_hand_counts(config, entry, unit_flops):
    got = registry.module("flops", config).per_unit(entry, registry.config(config), {})
    assert abs(got / unit_flops - 1) < 0.01


@pytest.mark.parametrize("kernel, bound_ms, by", [
    ("nn_distance_cuda", 0.0401, "operations"),
    ("chamfer_grad1_cuda", 0.0020, "bytes"),
])
def test_frozen_kernel_bounds_match_the_kernel_table(kernel, bound_ms, by):
    ms, got_by, _ = peaks.kernel_bound(kernel, 64, 2048, 2048)
    assert round(ms, 4) == bound_ms and got_by == by


def test_trace_reduction_unions_device_intervals_and_names_gaps():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    device = [
        ev("kernel", "void a<true>()", 100.0, 10.0),
        ev("kernel", "void b()", 105.0, 10.0),  # overlaps a: 105-115
        ev("gpu_memcpy", "Memcpy HtoD", 150.0, 10.0),
        ev("kernel", "void a<true>()", 190.0, 30.0),
    ]
    t = reduce_device(device, 200e-6)
    assert t["window_s"] == pytest.approx(200e-6)
    assert t["busy_s"] == pytest.approx((15 + 10 + 30) * 1e-6)
    assert len(t["kernels"]) == 3
    assert t["device_ops"][0][0] == "void a<true>()"
    host = [
        ev("user_annotation", "bench_window", 100.0, 100.0),
        ev("kernel", "void a<true>()", 90.0, 20.0),  # clipped to 100-110
        ev("kernel", "void b()", 105.0, 10.0),
        ev("gpu_memcpy", "Memcpy HtoD", 150.0, 10.0),
        ev("kernel", "void a<true>()", 190.0, 30.0),  # clipped to 190-200
        ev("cpu_op", "aten::mm", 110.0, 50.0),
        ev("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0),
    ]
    gaps = dict(reduce_host(host)["idle_gaps"])
    assert gaps["host: aten::mm"] == pytest.approx(35e-6)  # 115-150
    assert gaps["host: python"] == pytest.approx(30e-6)  # 160-190


def test_no_module_loads_jax_or_the_jax_package():
    """Top-level names compared whole: the port's name begins with the JAX
    package's. The reference imports nothing of the port either."""
    banned = {"jax", "jaxlib", "flax", "geometric_adv_tpu"}
    for path in (ROOT / "h100_bench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, f"{path}: imports {name}"
                if path.parent.name == "reference":
                    assert top != "geometric_adv_tpu_torch", f"{path}: imports {name}"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", ATTACK, "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr


# --- whole cells at a small size on the CPU ----------------------------------

SMALL = {"pointnet_ae_chamfer_2048": {"n_points": 64}}
SMALL_TRAFFIC = {"pairs_per_call": 4, "check_pairs_per_call": 3, "bn_calibration_clouds": 16,
                 "train_clouds": 160, "epochs_per_call": 1, "follow_iterations": [1, 5]}


def small_cell(name: str, seed: int = 2**31 + 99, cell: harness.Cell | None = None
               ) -> harness.Cell:
    """The workload's cell (or ``cell``) at a size a test holds: its
    widths, 64 points, short attacks."""
    cell = cell or harness.cell_from_files(name, seed)
    cell.config.update(SMALL[cell.workload["config"]])
    if "attack" in cell.config:
        cell.config["attack"].update(num_iterations=20, num_iterations_thresh=16)
    cell.traffic.update({k: v for k, v in SMALL_TRAFFIC.items() if k in cell.traffic})
    cell.workload.update(trace_host=[0, 1], trace_device=[1, 3])
    cell.device = torch.device("cpu")
    return cell


def run_small(cell: harness.Cell, trace: bool = False):
    return harness.execute(cell, registry.benchmark(), 0.0, trace, time.perf_counter())


def test_a_new_workload_file_is_picked_up_by_name(tmp_path, monkeypatch):
    """A cell added as data files alone: a workload, a traffic mix and a
    BENCHMARK.json line, no edit of an existing file."""
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "dummy_small", "config": "pointnet_ae_chamfer_2048",
                               "traffic": "dummy_pairs", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("dummy_small")
    for m in bench["per_layer"]:
        if m["moves"] == "attack_pair_iters_per_s":
            m["workloads"].append("dummy_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    work = dict(registry.workload(ATTACK), traffic="dummy_pairs")
    (tmp_path / "h100_bench/workloads/dummy_small.json").write_text(json.dumps(work))
    traffic = dict(registry.traffic("victim_pairs_b500"), **{
        k: v for k, v in SMALL_TRAFFIC.items() if k != "train_clouds"})
    del traffic["epochs_per_call"]
    (tmp_path / "h100_bench/traffic/dummy_pairs.json").write_text(json.dumps(traffic))
    monkeypatch.setattr(registry, "BENCH", tmp_path / "h100_bench")
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    cell = small_cell("dummy_small", cell=harness.load_cell("dummy_small", 5)[0])
    assert cell.traffic["pairs_per_call"] == 4
    result, checks, _ = run_small(cell, trace=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and set(result["checks"]) == {c.name for c in checks}
    assert {"correct", "attempted", "failed", "metrics", "device", "breakdown"} <= set(result)
    assert type(result["attempted"]) is int and result["attempted"] >= 1
    assert type(result["failed"]) is int and 0 <= result["failed"] <= result["attempted"]
    assert "mfu.attack_step" in result["metrics"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes",
                                     "busy_s", "window_s"}
    json.dumps(result)


@pytest.mark.parametrize("cell", WORKLOADS)
def test_a_sound_small_run_is_correct(cell):
    result, _, _ = run_small(small_cell(cell))
    assert result["correct"], result["checks"]
    rate = registry.workload(cell)["rate_metric"]
    assert list(result["metrics"]) == ([rate] if cell in CELLS else []) + ["setup_s"]


def _attack_state_unchanged(mp):
    from geometric_adv_tpu_torch.attack import core

    mp.setattr(core, "_tf_adam_update", lambda g, m, v, t, lr: (torch.zeros_like(g), m, v))


def _attack_half_batch(mp):
    """Half of each call's pairs left out: their outputs are the other
    half's."""
    from geometric_adv_tpu_torch.attack import core

    orig = core.attack_batch

    def half(*args, **kw):
        out = orig(*args, **kw)
        h = out.metrics.shape[1] // 2
        return core.AttackOutputs(*(np.concatenate([a[:, :h], a[:, :a.shape[1] - h]], axis=1)
                                    for a in out))

    mp.setattr(core, "attack_batch", half)


def _attack_altered(mp):
    from geometric_adv_tpu_torch.attack import core

    orig = core.AttackRunner.attack

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        return core.AttackOutputs(out.metrics, out.pc_input + 1e-3, out.pc_recon)

    mp.setattr(core.AttackRunner, "attack", altered)


def _train_state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_batch(mp):
    from geometric_adv_tpu_torch.train import trainer

    loss = trainer.reconstruction_loss_per_pc
    mp.setattr(trainer, "reconstruction_loss_per_pc",
               lambda r, g, t: loss(r, g, t)[: len(r) // 2])


def _train_altered(mp):
    from geometric_adv_tpu_torch.train import trainer

    loss = trainer.reconstruction_loss_per_pc
    mp.setattr(trainer, "reconstruction_loss_per_pc", lambda r, g, t: loss(r * 1.01, g, t))


def _in_window(mp, alter_step):
    """Patch the trainer's step with ``alter_step(step)`` in the window's
    calls alone: the start's one-batch calls train soundly."""
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    train = AETrainer.train

    def patched(self, data, conf=None, *a, **kw):
        if data.num_examples <= self.conf.batch_size:
            return train(self, data, conf, *a, **kw)
        self._train_step = alter_step(self._train_step)
        try:
            return train(self, data, conf, *a, **kw)
        finally:
            del self._train_step

    mp.setattr(AETrainer, "train", patched)


def _train_window_half_batch(mp):
    _in_window(mp, lambda step: lambda x, gt: step(x[: len(x) // 2], gt[: len(gt) // 2]))


def _train_repeats_a_batch(mp):
    """Every other step of the window feeds the batch before it again."""
    def alter(step):
        last = []

        def repeat(x, gt):
            if last:
                x, gt = last.pop()
            else:
                last.append((x, gt))
            return step(x, gt)
        return repeat

    _in_window(mp, alter)


def _train_turns_tf32_on(mp):
    """The program sets TF32 on: it departs from its configuration."""
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    mp.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # put back after the test
    train = AETrainer.train

    def tf32(self, *a, **kw):
        torch.backends.cuda.matmul.allow_tf32 = True
        return train(self, *a, **kw)

    mp.setattr(AETrainer, "train", tf32)


FAULTS = [
    (ATTACK, _attack_state_unchanged), (ATTACK, _attack_half_batch), (ATTACK, _attack_altered),
    (VICTIM, _train_state_unchanged), (VICTIM, _train_half_batch), (VICTIM, _train_altered),
    (VICTIM, _train_window_half_batch), (VICTIM, _train_repeats_a_batch),
    (VICTIM, _train_turns_tf32_on),
]


@pytest.mark.parametrize("cell, plant", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_planted_fault_makes_the_run_incorrect(cell, plant, monkeypatch):
    """A run whose timed path is broken underneath (the harness's look for a
    card skipped): a step that leaves its state unchanged, half of the batch
    left out with the mean over the rest, an answer altered where it is
    made. One chip: no exchange between chips to leave out."""
    plant(monkeypatch)
    result, _, _ = run_small(small_cell(cell))
    assert not result["correct"], result["checks"]
    caught_by = {"_train_window_half_batch": "step_grad_gap", "_train_repeats_a_batch": "feed_gap",
                 "_train_turns_tf32_on": "precision_departures"}.get(plant.__name__)
    if caught_by:
        got = result["checks"][caught_by]
        assert not got["value"] <= got["limit"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed", "7",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card(cell):
    """The reference with TF32 on, put in the program's place, reads past a
    limit (the readings at the cell's own size: ``calibrate.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    small = small_cell(cell)
    small.device = torch.device("cuda:0")
    small.info["chips"] = 1
    entry = registry.module("entries", small.workload["entry"])
    checks = entry.control(entry.setup(small), "tf32")
    assert not all(c.ok for c in checks), [(c.name, c.value) for c in checks]
