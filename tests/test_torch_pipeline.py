"""The port's pipeline runner (geometric_adv_tpu_torch/runner_pipeline.py)
against ``runner_pipeline.sh``, and the ported frozen-run tools
(geometric_adv_tpu_torch/tools/) against ``tools/``.

- ``plan("quick")`` and ``plan("full")`` equal the script's stage list as
  parsed here from the script itself (its ``run $PY ...`` commands joined
  over their continuations, each mode's variables), with the module prefix
  swapped and ``--device`` the only addition;
- a failing stage ends the run with its exit code, once (no retry), and
  ``--device cuda`` on a machine without CUDA fails rather than falls back;
- the whole plan at a tiny size on the CPU, each stage run in this process
  (30 interpreter start-ups would cost ~100 s here): ``PIPELINE COMPLETE``,
  every artifact of ``runner_pipeline.check_artifacts`` and the identity
  sanity of every class;
- on that tree with a frozen-10 replay added: the port's
  ``compare_frozen`` prints what the JAX tool prints, and
  ``frozen_exact_reeval``'s S-CD and T-RE equal the JAX package's
  ``chamfer_loss_per_pc`` on the same sampled pairs within 1e-6 relative.
"""

import json
import os.path as osp
import re
import runpy
import shlex
import subprocess
import sys
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest
import torch

from geometric_adv_tpu_torch import runner_pipeline as rp

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCRIPT = osp.join(REPO, "runner_pipeline.sh")

TINY = {
    "N_POINTS": "64", "N_PER_CLASS": "40", "EPOCHS": "1", "CLS_EPOCHS": "1",
    "TR_EPOCHS": "1", "NUM_ATTACK": "2", "NUM_TARGET": "2", "ITERS": "5",
    "THRESH": "3", "SEL": "4", "ABATCH": "0", "DATA": "data/tiny",
    "CLASS_ARGS": "--class_names sphere cube cone",
    # 4 patches of 16 points: square grids, which metro triangulates
    "ATLAS_ARGS": "--nb_primitives 4 --template_type SQUARE --number_points 64",
    "METRO_ARGS": "--num_per_class 1 --n_samples 500",
    "BS_ARG": "--batch_size 10",
}
CLASSES = TINY["CLASS_ARGS"].split()[1:]
REPLAY_FOLDER = "attack_res_frozen10"


def replay_plan(stages):
    """The frozen-10 replay of the output-space attack, as the reference-scale
    run makes it: plan stages 5-7 with the same flags into
    ``attack_res_frozen10``."""
    attack, dists, evaluate = (list(s) for s in stages[4:7])
    assert attack[2].endswith(".run_attack") and "--loss_adv_type" not in attack
    return [attack + ["--chamfer_refresh", "10", "--output_folder_name", REPLAY_FOLDER],
            dists + ["--attack_folder", REPLAY_FOLDER],
            evaluate + ["--output_folder_name", REPLAY_FOLDER]]


def _assignments(text):
    out = {}
    for stmt in re.split(r"[;\n]", text):
        words = shlex.split(stmt, comments=True)
        if len(words) == 1 and re.fullmatch(r"[A-Z_]+=.*", words[0]):
            name, value = words[0].split("=", 1)
            out[name] = value
    return out


def script_plan(mode):
    """The script's stage argvs for ``mode``, expanded as the shell would."""
    with open(SCRIPT) as f:
        text = f.read().replace("\\\n", " ")
    quick, full = re.search(
        r'^if \[ "\$MODE" = "quick" \]; then\n(.*?)\nelse\n(.*?)\nfi$', text,
        re.S | re.M).groups()
    variables = _assignments(quick if mode == "quick" else full)
    one_line = re.search(
        r'^if \[ "\$MODE" = "quick" \]; then (.*?); else (.*?); fi$', text, re.M)
    variables.update(_assignments(one_line[1] if mode == "quick" else one_line[2]))
    for line in text.splitlines():
        if re.fullmatch(r"(PY|AE|SEL_IDX)=.*", line):
            name, value = shlex.split(line)[0].split("=", 1)
            variables[name] = re.sub(r"\$\{?(\w+)\}?",
                                     lambda m: variables[m[1]], value)
    stages = []
    for line in text.splitlines():
        if line.startswith("run $PY "):
            expanded = re.sub(r"\$\{?(\w+)\}?", lambda m: variables[m[1]], line)
            stages.append(shlex.split(expanded)[1:])
    assert text.rstrip().endswith('echo "PIPELINE COMPLETE"')
    return stages


@pytest.mark.parametrize("mode", ["quick", "full"])
def test_plan_equals_the_script(mode):
    want = script_plan(mode)
    assert len(want) == 30
    got = rp.plan(mode)
    assert [a[1:] for a in got] == [
        [w[1], w[2].replace("geometric_adv_tpu.cli.", "geometric_adv_tpu_torch.cli."),
         *w[3:]] for w in want]
    assert all(w[0] == "python" and a[0] == sys.executable for a, w in zip(got, want))
    # --device is the only addition, after the script's flags
    for plain, with_device in zip(got, rp.plan(mode, "cuda")):
        stage = plain[2].rsplit(".", 1)[1]
        extra = [] if stage in rp.HOST_STAGES else ["--device", "cuda"]
        assert with_device == plain + extra


def test_host_stages_are_those_without_a_device_flag():
    stages = {a[2] for a in rp.plan("full")}
    for module in stages:
        path = osp.join(REPO, *module.split(".")) + ".py"
        with open(path) as f:
            takes_device = "add_device_flag(parser)" in f.read()
        assert takes_device == (module.rsplit(".", 1)[1] not in rp.HOST_STAGES), module


def test_a_failing_stage_ends_the_run_once(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name, body in (("ok_stage", "open('ok', 'a').write('x')"),
                       ("failing_stage", "open('failed', 'a').write('x')\n"
                                         "raise SystemExit(3)"),
                       ("never_stage", "open('never', 'w')")):
        (tmp_path / f"{name}.py").write_text(body + "\n")
    stages = [[sys.executable, "-m", m] for m in ("ok_stage", "failing_stage", "never_stage")]
    assert rp.run(stages) == 3
    assert open("ok").read() == "x" and open("failed").read() == "x"  # ran once
    assert not osp.exists("never")
    with open(rp.STAGES_RECORD) as f:
        record = json.load(f)
    assert [(r["module"], r["rc"], r["peak_device_bytes"], r["launches"])
            for r in record] == [("ok_stage", 0, None, {}), ("failing_stage", 3, None, {})]


def test_cuda_absent_fails_the_run(tmp_path):
    """The default ``--device cuda`` on a machine without CUDA: the dataset
    stage (host) runs, the victim's training raises, and its exit code ends
    the run; nothing moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    out = subprocess.run(
        [sys.executable, "-m", "geometric_adv_tpu_torch.runner_pipeline", "quick"],
        cwd=tmp_path, env=rp.stage_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stdout[-2000:] + out.stderr[-2000:]
    assert "CUDA is not available" in out.stderr
    assert "PIPELINE COMPLETE" not in out.stdout
    assert "== stage 2 train_ae: exit 1" in out.stdout
    assert "== stage 3/" not in out.stdout


def _in_process(argv, env=None):
    """``subprocess.call`` for a ``python -m module ...`` stage, run in this
    process."""
    saved = sys.argv
    sys.argv = [argv[2], *argv[3:]]
    try:
        runpy.run_module(argv[2], run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else int(e.code is not None)
    finally:
        sys.argv = saved
    return 0


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The whole plan at the tiny size on the CPU, then the frozen-10 replay
    of the output-space attack; -> (directory, the runner's output)."""
    d = tmp_path_factory.mktemp("pipeline")
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(rp.MODES, "tiny", TINY)
        mp.setattr(rp.subprocess, "call", _in_process)
        mp.chdir(d)
        buf = StringIO()
        with redirect_stdout(buf):
            rc = rp.main(["tiny", "--device", "cpu"])
            replay_rc = rp.run(replay_plan(rp.plan("tiny", "cpu")), "log/replay.json")
        assert (rc, replay_rc) == (0, 0), buf.getvalue()[-3000:]
        assert osp.isdir(osp.join(d, rp.AE, "eval", REPLAY_FOLDER))
    finally:
        mp.undo()
    return str(d), buf.getvalue()


def test_tiny_pipeline_end_to_end(tiny_run, monkeypatch):
    d, out = tiny_run
    assert "PIPELINE COMPLETE" in out
    monkeypatch.setitem(rp.MODES, "tiny", TINY)
    assert rp.check_artifacts("tiny", d) == []
    with open(osp.join(d, rp.STAGES_RECORD)) as f:
        record = json.load(f)
    assert [r["stage"] for r in record] == list(range(1, 31))
    assert all(r["rc"] == 0 and r["wall_s"] > 0 for r in record)
    # the identity transfer replays the attack for every class
    assert out.count("identity sanity checks passed") == len(CLASSES)


def test_compare_frozen_prints_as_the_jax_tool(tiny_run):
    d, _ = tiny_run
    env = dict(rp.stage_env(), JAX_PLATFORMS="cpu")
    jax_out = subprocess.run(
        [sys.executable, osp.join(REPO, "tools", "compare_frozen.py"),
         osp.join(d, rp.AE, "eval"), REPLAY_FOLDER],
        env=env, capture_output=True, text=True, timeout=300, check=True).stdout
    port_out = subprocess.run(
        [sys.executable, "-m", "geometric_adv_tpu_torch.tools.compare_frozen",
         "--project_dir", d, "--frozen_folder", "attack_res_frozen10"],
        env=env, capture_output=True, text=True, timeout=300, check=True).stdout
    assert port_out == jax_out
    assert f"over {len(CLASSES)} classes" in port_out


def test_frozen_exact_reeval_matches_jax_chamfer(tiny_run, capsys):
    from geometric_adv_tpu.ops import chamfer_loss_per_pc as jax_chamfer
    from geometric_adv_tpu_torch.cli.common import NN_IDX_DICT, AttackContext
    from geometric_adv_tpu_torch.tools import frozen_exact_reeval as fer
    from geometric_adv_tpu_torch.utils.artifacts import load_data

    d, _ = tiny_run
    sel = f"{rp.AE}/eval/sel_idx_rand_{TINY['SEL']}_test_set_13l.npy"
    argv = ["--project_dir", d, "--attack_pc_idx", sel, "--num_pc_for_attack",
            TINY["NUM_ATTACK"], "--classes", "sphere", "cone", "--device", "cpu"]
    fer.main(argv)
    printed = capsys.readouterr().out
    ctx = AttackContext(d, rp.AE, attack_folder="attack_res", attack_pc_idx=sel,
                        num_pc_for_attack=int(TINY["NUM_ATTACK"]))
    ctx.nn_idx = load_data(ctx.data_path, ctx.files,
                           [NN_IDX_DICT[ctx.conf.target_pc_idx_type]])
    runs = ("attack_res", REPLAY_FOLDER)
    rows = fer.reeval(ctx, ["sphere", "cone"], runs, "cpu")
    rng = np.random.RandomState(0)
    for cls in ("sphere", "cone"):
        src, tgt = ctx.class_attack_data(cls, ctx.point_clouds)
        idx = rng.choice(len(src), min(192, len(src)), replace=False)
        for run in runs:
            folder = osp.join(ctx.data_path, run, cls)
            adv = np.load(osp.join(folder, "adversarial_pc_input.npy"))[0][idx]
            rec = np.load(osp.join(folder, "adversarial_pc_recon.npy"))[0][idx]
            scd = np.asarray(jax_chamfer(adv, src[idx])).mean()
            tre = np.asarray(jax_chamfer(rec, tgt[idx])).mean()
            (got,) = [r for r in rows if r[:2] == (cls, run)]
            np.testing.assert_allclose(got[2:], [scd, tre, scd + tre], rtol=1e-6)
            assert f"{cls:>8} {run:>22} {got[2]:.6f}  {got[3]:.6f}  {got[4]:.6f}" in printed
        assert f"{cls}: frozen/exact exact-measured ratios" in printed


def test_stage_report_holds_peak_memory_and_launches(tmp_path, monkeypatch):
    """What a stage writes at exit where CUDA was used: its start-up, peak
    device memory, the launch counts of the wrapper modules it loaded and
    the program's counters."""
    from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
    from geometric_adv_tpu_torch.utils import profiling, stage_report

    monkeypatch.setattr(profiling, "_COUNTS", {})
    profiling.count("attack.pair_iters", 250_000)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 12345)
    monkeypatch.setattr(cu.nn_distance_cuda, "launches", 7)
    path = tmp_path / "report.json"
    stage_report._write_report(str(path), 2.5)
    report = json.loads(path.read_text())
    assert report["startup_s"] == 2.5
    assert report["peak_device_bytes"] == 12345
    assert report["launches"]["nn_distance_cuda"] == 7
    assert set(cu.launch_counts()) <= set(report["launches"])
    assert report["counters"] == {"attack.pair_iters": 250_000}


def test_stage_report_without_cuda(tmp_path, monkeypatch):
    """A stage that never touched CUDA still reports its start-up."""
    from geometric_adv_tpu_torch.utils import profiling, stage_report

    if torch.cuda.is_initialized():
        pytest.skip("CUDA is initialised in this process")
    monkeypatch.setattr(profiling, "_COUNTS", {})
    path = tmp_path / "report.json"
    stage_report._write_report(str(path), 1.25)
    assert json.loads(path.read_text()) == {
        "startup_s": 1.25, "peak_device_bytes": None, "launches": {},
        "counters": {}}


@pytest.mark.parametrize("primary", [True, False])
def test_stage_report_registers_on_the_primary_rank_only(tmp_path, monkeypatch, primary):
    """Under a process group every rank imports cli/common; only the primary
    registers the write, so the ranks do not overwrite one file. The start-up
    runs from the runner's spawn time."""
    import geometric_adv_tpu_torch.parallel as parallel
    from geometric_adv_tpu_torch.utils import stage_report

    registered = []
    monkeypatch.setattr(stage_report.atexit, "register",
                        lambda fn, *args: registered.append(args))
    monkeypatch.setattr(parallel, "is_primary", lambda: primary)
    monkeypatch.setenv(stage_report.STAGE_REPORT_ENV, str(tmp_path / "r.json"))
    monkeypatch.setenv(stage_report.STAGE_SPAWNED_ENV, repr(stage_report.time.time() - 3.0))
    stage_report.report_stage_at_exit()
    if not primary:
        assert registered == []
        return
    ((path, startup_s),) = registered
    assert path == str(tmp_path / "r.json")
    assert 3.0 <= startup_s < 60.0


def test_runner_records_each_stage_start_up(tmp_path, monkeypatch):
    """A stage that imports cli/common in a process of its own: the runner
    records the start-up it reports (no CUDA used: no peak, no launches)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "common_stage.py").write_text(
        "import geometric_adv_tpu_torch.cli.common\n")
    assert rp.run([[sys.executable, "-m", "common_stage"]]) == 0
    with open(rp.STAGES_RECORD) as f:
        (r,) = json.load(f)
    assert r["peak_device_bytes"] is None and r["launches"] == {}
    assert r["counters"] == {}
    assert 0.0 < r["startup_s"] <= r["wall_s"]
