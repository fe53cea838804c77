"""The port's attack slice end to end against the JAX package, on the CPU.

Quick tier: one tiny synthetic dataset (3 classes x 40 clouds x 64 points)
and one JAX-initialised victim (bneck 16, as tests/test_cli_pipeline.py:
58-64) bridged into a port checkpoint. The JAX stage CLIs and the port's
(``--device cpu``) then run
tst_ae -> prepare_indices_for_attack -> run_attack (5 iterations) ->
get_dists_per_point -> evaluate_attack -> run_defense_critical (with its
replay checks) -> evaluate_defense (adversarial and clean) ->
get_knn_dists_per_point -> run_defense_surface -> evaluate_defense
in-process on the same data, the port's attack with JAX's ``init_pert``
draw injected; then, from checkpoints bridged from the JAX package's, the
classifier stages (run_classifier for the five data types, evaluate_classifier
both ways) and the transfer stages (tst/run/evaluate_transfer for AtlasNet
and FoldingNet). Bars: latents and AE loss 1e-5; chamfer matrix 1e-7; index
artifacts exact; attack and defense metrics rtol 2e-4 / atol 1e-6 and
clouds 1e-5 (tests/test_attack.py:116-118); critical indices exact; kNN
distances rtol 1e-6; eval_stats.txt text-equal; predicted labels equal;
transfer metrics rtol 2e-4 / atol 1e-6, transferred clouds 1e-5, transfer
AE test loss rtol 1e-5.

EMD leg (quick tier): a tiny EMD victim trained by the JAX package for one
epoch, bridged with its weights, then the same stages at the same bars, the
attack with ``--loss_dist_type pert``. With the EMD input distance as the
attack's distance term the two packages cannot agree at these bars: at the
attack's start adv - x is ~1e-7, and the JAX package's CPU sweep forms that
term's gradient as ``x * s0 - s1`` from float32 terms near 3e6, whose
cancellation leaves errors up to 0.45 * |g| (24 of 288 signs flipped in the
first Adam step on the victim of tests/test_torch_attack.py); the port's
float64 sums give the analytic gradient there
(tests/test_torch_ops_emd.py::test_emd_gradient_at_a_tiny_displacement).

Slow tier: tests/test_cli_pipeline.py:50-120 (the attack and both
defenses) and its EMD leg (:311-369) replayed with the port's stages from the
JAX-trained tiny victims, then the classifier and transfer goldens (:145-227)
from the JAX CLIs' bridged checkpoints, against tests/golden/.
"""

import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from geometric_adv_tpu.attack.core import init_pert as jax_init_pert
from geometric_adv_tpu_torch.attack import core as port_core
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.train import checkpoint as port_ckpt

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GOLDEN_DIR = osp.join(REPO, "tests", "golden")
CLASSES = ["sphere", "cube", "torus"]
SEL = "eval/sel_idx_rand_4_test_set_13l.npy"
ATTACK = ["--num_pc_for_attack", "2", "--num_pc_for_target", "2",
          "--num_iterations", "5", "--num_iterations_thresh", "3"]


def jax_pert0(shape, device, stddev=1e-7, seed=55):
    """The port's init_pert replaced by the JAX package's draw."""
    return torch.tensor(np.asarray(jax_init_pert(shape, stddev, seed))).to(device)


def run_port_stages(monkeypatch, d, ae, attack=ATTACK, sel=SEL, per_class="4"):
    from geometric_adv_tpu_torch.cli import (
        evaluate_attack,
        get_dists_per_point,
        prepare_indices_for_attack,
        run_attack,
        tst_ae,
    )

    monkeypatch.setattr(port_core, "init_pert", jax_pert0)
    c = ["--project_dir", d]
    cpu = ["--device", "cpu"]
    sel = f"{ae}/{sel}"
    tst_ae.main(c + cpu + ["--data_folder", "data/tiny", "--train_folder", ae])
    prepare_indices_for_attack.main(
        c + cpu + ["--ae_folder", ae, "--get_rand_idx", "1",
                   "--get_latent_nn_idx", "1", "--get_chamfer_nn_idx", "1",
                   "--num_instance_per_class", per_class])
    run_attack.main(c + cpu + ["--ae_folder", ae, "--attack_pc_idx", sel] + attack)
    get_dists_per_point.main(c + cpu + ["--ae_folder", ae, "--attack_pc_idx", sel])
    evaluate_attack.main(c + ["--ae_folder", ae, "--attack_pc_idx", sel])


def run_jax_stages(monkeypatch, d, ae, attack=ATTACK):
    from geometric_adv_tpu.cli import (
        evaluate_attack,
        get_dists_per_point,
        prepare_indices_for_attack,
        run_attack,
        tst_ae,
    )

    c = ["--project_dir", d]
    sel = f"{ae}/{SEL}"
    for mod, args in (
        (tst_ae, ["--data_folder", "data/tiny", "--train_folder", ae]),
        (prepare_indices_for_attack,
         ["--ae_folder", ae, "--get_rand_idx", "1", "--get_latent_nn_idx", "1",
          "--get_chamfer_nn_idx", "1", "--num_instance_per_class", "4"]),
        (run_attack, ["--ae_folder", ae, "--attack_pc_idx", sel,
                      "--use_mesh", "0"] + attack),
        (get_dists_per_point, ["--ae_folder", ae, "--attack_pc_idx", sel]),
        (evaluate_attack, ["--ae_folder", ae, "--attack_pc_idx", sel]),
    ):
        monkeypatch.setattr(sys, "argv", ["stage"] + c + args)
        mod.main()


def defense_stages(ae, sel=SEL):
    """(stage, flags, runs on a device) of the defense CLIs, in order."""
    a = ["--ae_folder", ae, "--attack_pc_idx", f"{ae}/{sel}"]
    crit = ["--defense_folder", "defense_critical_res"]
    return [
        ("run_defense_critical", a + ["--do_sanity_checks", "1"], True),
        ("evaluate_defense", a + crit, False),
        ("evaluate_defense", a + crit + ["--use_adversarial_data", "0"], False),
        ("get_knn_dists_per_point", a, True),
        ("run_defense_surface", a, True),
        ("evaluate_defense", a + ["--defense_folder", "defense_surface_res"], False),
    ]


def run_defenses(monkeypatch, d, ae, package, sel=SEL):
    """The defense stages of ``package`` ("jax" or "port", on the CPU)."""
    import importlib

    root = "geometric_adv_tpu" if package == "jax" else "geometric_adv_tpu_torch"
    for stage, flags, on_device in defense_stages(ae, sel):
        mod = importlib.import_module(f"{root}.cli.{stage}")
        argv = ["--project_dir", d] + flags
        if package == "jax":
            monkeypatch.setattr(sys, "argv", ["stage"] + argv)
            mod.main()
        else:
            mod.main(argv + (["--device", "cpu"] if on_device else []))


def bridge_checkpoint(params, batch_stats, train_dir, epoch):
    port_ckpt.save_checkpoint(
        train_dir, epoch,
        state_dict_from_flax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, batch_stats)),
    )


@pytest.fixture(scope="module")
def slice_dirs(tmp_path_factory):
    from geometric_adv_tpu.data.synthetic import make_shapenet_like_dir
    from geometric_adv_tpu.train import AETrainer, Configuration

    d = str(tmp_path_factory.mktemp("slice"))
    make_shapenet_like_dir(osp.join(d, "data/tiny"), CLASSES, n_per_class=40,
                           n_points=64, seed=0)
    conf = Configuration(n_input=[64, 3], bneck_size=16, batch_size=10,
                         class_names=CLASSES)
    jax_ae, port_ae = "log/jax_ae", "log/port_ae"
    for ae in (jax_ae, port_ae):
        conf.train_dir = osp.join(d, ae)
        conf.save(osp.join(d, ae, "configuration"))
    trainer = AETrainer(conf)  # flax init, seed 42
    trainer.save(osp.join(d, jax_ae), 1)
    bridge_checkpoint(trainer.state.params, trainer.state.batch_stats,
                      osp.join(d, port_ae), 1)
    with pytest.MonkeyPatch.context() as mp:
        run_jax_stages(mp, d, jax_ae)
        run_defenses(mp, d, jax_ae, "jax")
        run_port_stages(mp, d, port_ae)
        run_defenses(mp, d, port_ae, "port")
    return (osp.join(d, jax_ae, "eval"), osp.join(d, port_ae, "eval"))


def load_pair(dirs, rel):
    return tuple(np.load(osp.join(e, rel)) for e in dirs)


def test_slice_tst_ae_matches_jax(slice_dirs):
    for rel in ("point_clouds_test_set_13l.npy", "slice_idx_test_set_13l.npy",
                "pc_label_test_set_13l.npy", "pc_classes_13l.npy"):
        want, got = load_pair(slice_dirs, rel)
        np.testing.assert_array_equal(got, want, err_msg=rel)
    for rel in ("latent_vectors_test_set_13l.npy", "ae_loss_test_set_13l.npy",
                "reconstructions_test_set_13l.npy"):
        want, got = load_pair(slice_dirs, rel)
        assert got.shape == want.shape and got.dtype == want.dtype, rel
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=rel)


def test_slice_indices_match_jax(slice_dirs):
    want, got = load_pair(slice_dirs, "chamfer_dist_mat_complete_test_set_13l.npy")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    for rel in ("sel_idx_rand_4_test_set_13l.npy",
                "chamfer_nn_idx_complete_test_set_13l.npy",
                "latent_nn_idx_test_set_13l.npy"):
        want, got = load_pair(slice_dirs, rel)
        assert got.dtype == want.dtype, rel
        np.testing.assert_array_equal(got, want, err_msg=rel)


@pytest.mark.parametrize("cls", CLASSES)
def test_slice_attack_matches_jax(slice_dirs, cls):
    res = f"attack_res/{cls}/"
    want, got = load_pair(slice_dirs, res + "adversarial_metrics.npy")
    assert got.shape == want.shape == (1, 8, 5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    for name in ("adversarial_pc_input.npy", "adversarial_pc_recon.npy",
                 "adversarial_pc_input_dists.npy"):
        want, got = load_pair(slice_dirs, res + name)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    want, got = load_pair(
        slice_dirs, res + "analysis_results/source_target_norm_min_idx.npy")
    np.testing.assert_array_equal(got, want)


def test_slice_eval_stats_match_jax(slice_dirs):
    texts = [open(osp.join(e, "attack_res/over_classes/eval_stats.txt")).read()
             for e in slice_dirs]
    assert texts[1] == texts[0]


def assert_defense_matches(dirs, defense, cls, outliers):
    """One class's defense artifacts, both runs: index artifacts exact,
    metrics at the attack's bar, clouds at 1e-5, shapes and dtypes equal.
    ``outliers`` names the surface defense's extra points."""
    res = f"attack_res/{defense}/{cls}/"
    orig = f"attack_res/{defense}_orig/{cls}/"
    for rel in (res + "adversarial_critical_idx.npy",
                res + "adversarial_critical_num.npy",
                orig + "original_critical_idx.npy",
                orig + "original_critical_num.npy"):
        want, got = load_pair(dirs, rel)
        assert got.dtype == want.dtype, rel
        np.testing.assert_array_equal(got, want, err_msg=rel)
    for rel in (res + "defense_metrics.npy", orig + "defense_source_metrics.npy"):
        want, got = load_pair(dirs, rel)
        assert got.shape == want.shape and got.dtype == want.dtype, rel
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6, err_msg=rel)
    for rel in (res + outliers, res + "defended_pc_input.npy",
                res + "defended_pc_recon.npy",
                orig + "original_source_critical_points.npy",
                orig + "defended_source_input.npy",
                orig + "defended_source_recon.npy"):
        want, got = load_pair(dirs, rel)
        assert got.shape == want.shape and got.dtype == want.dtype, rel
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=rel)


@pytest.mark.parametrize("cls", CLASSES)
def test_slice_critical_defense_matches_jax(slice_dirs, cls):
    assert_defense_matches(slice_dirs, "defense_critical_res", cls,
                           "adversarial_critical_points.npy")
    want, got = load_pair(
        slice_dirs, f"attack_res/defense_critical_res/{cls}/defense_metrics.npy")
    assert got.shape == (1, 8, 4)


@pytest.mark.parametrize("cls", CLASSES)
def test_slice_surface_defense_matches_jax(slice_dirs, cls):
    for rel in (f"attack_res/defense_surface_res/{cls}/"
                "knn_dists_adversarial_pc_input.npy",
                f"attack_res/defense_surface_res_orig/{cls}/knn_dists_source_pc.npy"):
        want, got = load_pair(slice_dirs, rel)
        assert got.shape == want.shape and got.dtype == want.dtype, rel
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=rel)
    assert_defense_matches(slice_dirs, "defense_surface_res", cls,
                           "adversarial_critical_points.npy")


@pytest.mark.parametrize("defense", ["defense_critical_res",
                                     "defense_critical_res_orig",
                                     "defense_surface_res"])
def test_slice_defense_eval_stats_match_jax(slice_dirs, defense):
    texts = [open(osp.join(e, f"attack_res/{defense}/over_classes/eval_stats.txt")).read()
             for e in slice_dirs]
    assert "Def" in texts[0] and texts[1] == texts[0]


def test_slice_defense_replay_check_catches_drift(slice_dirs, tmp_path):
    """run_defense_critical --do_sanity_checks 1 raises where the restored
    victim does not replay tst_ae's reconstructions within 1e-6."""
    import shutil

    from geometric_adv_tpu_torch.cli import run_defense_critical

    shutil.copytree(osp.dirname(slice_dirs[1]), tmp_path / "log/port_ae")
    rec = tmp_path / "log/port_ae/eval/reconstructions_test_set_13l.npy"
    np.save(rec, np.load(rec) + 2e-6)
    with pytest.raises(RuntimeError, match="source recon replay drift"):
        run_defense_critical.main([
            "--project_dir", str(tmp_path), "--device", "cpu", "--ae_folder",
            "log/port_ae", "--attack_pc_idx", f"log/port_ae/{SEL}",
            "--do_sanity_checks", "1"])


def png_files(root):
    return sorted(osp.relpath(osp.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs if f.endswith(".png"))


@pytest.mark.parametrize("flag", ["--save_pc_plots", "--save_graphs"])
def test_slice_evaluate_attack_plots_match_jax(slice_dirs, flag, monkeypatch):
    """evaluate_attack's plots: the port writes the JAX stage's files, under
    the same names, and its other artifacts stay those of a run without
    plots."""
    from geometric_adv_tpu.cli import evaluate_attack as jax_eval
    from geometric_adv_tpu_torch.cli import evaluate_attack as port_eval

    for ev, ae, run in zip(slice_dirs, ("log/jax_ae", "log/port_ae"),
                           ("jax", "port")):
        d = osp.dirname(osp.dirname(osp.dirname(ev)))
        argv = ["--project_dir", d, "--ae_folder", ae, "--attack_pc_idx",
                f"{ae}/{SEL}", flag, "1"]
        if run == "jax":
            monkeypatch.setattr(sys, "argv", ["stage"] + argv)
            jax_eval.main()
        else:
            port_eval.main(argv)
    want, got = (png_files(osp.join(ev, "attack_res")) for ev in slice_dirs)
    assert got and got == want
    test_slice_eval_stats_match_jax(slice_dirs)


def test_slice_run_attack_trace_dir_writes_a_trace(slice_dirs):
    """--trace_dir: a torch.profiler Chrome trace of the first class's
    attack, with the attack's operators in it."""
    import json

    from geometric_adv_tpu_torch.cli import run_attack

    ev = slice_dirs[1]
    d = osp.dirname(osp.dirname(osp.dirname(ev)))
    trace_dir = osp.join(d, "trace")
    run_attack.main(["--project_dir", d, "--device", "cpu", "--ae_folder",
                     "log/port_ae", "--attack_pc_idx", f"log/port_ae/{SEL}",
                     "--num_pc_for_attack", "1", "--num_pc_for_target", "1",
                     "--num_iterations", "2", "--num_iterations_thresh", "1",
                     "--output_folder_name", "attack_res_trace",
                     "--trace_dir", trace_dir])
    events = json.load(open(osp.join(trace_dir, "trace.json")))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::mm" in names or "aten::addmm" in names, sorted(names)[:50]
    assert osp.exists(osp.join(ev, "attack_res_trace/sphere/adversarial_metrics.npy"))


def test_make_synthetic_data_cli_matches_jax(tmp_path, monkeypatch):
    """The port's make_synthetic_data writes the JAX stage's PLY tree, byte
    for byte."""
    from geometric_adv_tpu.cli import make_synthetic_data as jax_cli
    from geometric_adv_tpu_torch.cli import make_synthetic_data as port_cli

    flags = ["--class_names", "sphere", "torus", "--n_per_class", "5",
             "--n_points", "40", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["stage", "--project_dir", str(tmp_path),
                                      "--data_folder", "jax", *flags])
    jax_cli.main()
    port_cli.main(["--project_dir", str(tmp_path), "--data_folder", "port", *flags])
    trees = []
    for root in (tmp_path / "jax", tmp_path / "port"):
        trees.append({osp.relpath(osp.join(dp, f), root): open(osp.join(dp, f), "rb").read()
                      for dp, _, fs in os.walk(root) for f in fs})
    assert len(trees[0]) == 10 and trees[1] == trees[0]


CLS_DATA_TYPES = ("target", "adversarial", "source", "before_defense", "after_defense")
TRANSFER_KINDS = {"atlasnet": ("AtlasNet", {"number_points": 64}), "foldingnet": ("FoldingNet", {})}


def run_cli(package, stage, argv, monkeypatch, device=True):
    """One stage of ``package`` ("jax" or "port", the port's on the CPU)."""
    import importlib

    root = "geometric_adv_tpu" if package == "jax" else "geometric_adv_tpu_torch"
    mod = importlib.import_module(f"{root}.cli.{stage}")
    if package == "jax":
        monkeypatch.setattr(sys, "argv", ["stage"] + argv)
        return mod.main()
    return mod.main(argv + (["--device", "cpu"] if device else []))


def bridge_tree(jax_dir, port_dir, epoch):
    from geometric_adv_tpu.train import checkpoint as jax_ckpt

    tree = jax_ckpt.restore_checkpoint(jax_dir, epoch)
    bridge_checkpoint(tree["params"], tree["batch_stats"], port_dir, epoch)


@pytest.fixture(scope="module")
def cls_transfer_dirs(slice_dirs):
    """The classifier and transfer stages on the slice fixture's attack and
    critical defense: the JAX CLIs on the JAX victim, the port's on its own,
    from checkpoints bridged from the JAX ones. The classifier is trained one
    epoch by the JAX CLI (which writes pc_pred_labels; the port's labels are
    its classify on the bridged checkpoint); AtlasNet (SPHERE, 64 points)
    and FoldingNet are saved at their flax init."""
    from geometric_adv_tpu.transfer import get_transfer_ae, save_transfer_arch
    from geometric_adv_tpu_torch.classify import ClassifierTrainer
    from geometric_adv_tpu_torch.transfer import save_transfer_arch as port_save_arch
    from geometric_adv_tpu_torch.utils.artifacts import load_data

    d = osp.dirname(osp.dirname(osp.dirname(slice_dirs[0])))
    aes = {"jax": "log/jax_ae", "port": "log/port_ae"}
    with pytest.MonkeyPatch.context() as mp:
        run_cli("jax", "train_classifier",
                ["--project_dir", d, "--ae_folder", aes["jax"], "--data_folder", "data/tiny",
                 "--max_epoch", "1", "--batch_size", "8", "--train_folder", "log/jax_cls"], mp)
        bridge_tree(osp.join(d, "log/jax_cls"), osp.join(d, "log/port_cls"), 1)
        port_cls = ClassifierTrainer(num_classes=len(CLASSES), device="cpu").restore(osp.join(d, "log/port_cls"))
        ev = slice_dirs[1]
        np.save(osp.join(ev, "pc_pred_labels_test_set_13l.npy"),
                port_cls.classify(load_data(ev, None, ["point_clouds_test_set"])))
        for kind, (_, arch) in TRANSFER_KINDS.items():
            jt = get_transfer_ae(kind, n_points_input=64, **arch)
            jt.save(osp.join(d, f"log/jax_{kind}"), 1)
            save_transfer_arch(osp.join(d, f"log/jax_{kind}"), kind, **arch)
            bridge_tree(osp.join(d, f"log/jax_{kind}"), osp.join(d, f"log/port_{kind}"), 1)
            port_save_arch(osp.join(d, f"log/port_{kind}"), kind, **arch)
        for package, ae in aes.items():
            a = ["--project_dir", d, "--ae_folder", ae, "--attack_pc_idx", f"{ae}/{SEL}"]
            for dt in CLS_DATA_TYPES:
                run_cli(package, "run_classifier", a + [
                    "--data_type", dt, "--classifier_folder", f"log/{package}_cls"], mp)
                for ct in ("hit_target", "avoid_source"):
                    run_cli(package, "evaluate_classifier", a + [
                        "--data_type", dt, "--classification_type", ct], mp)
            for kind, (name, _) in TRANSFER_KINDS.items():
                folder = f"log/{package}_{kind}"
                run_cli(package, "tst_transfer", ["--project_dir", d, "--ae_folder", ae,
                                                  "--ae_type", kind, "--train_folder", folder], mp)
                run_cli(package, "run_transfer", a + ["--transfer_ae_type", name,
                                                      "--transfer_ae_folder", folder], mp)
                run_cli(package, "evaluate_transfer", a + ["--transfer_ae_type", name], mp)
    return d, slice_dirs


def test_slice_classifier_labels_match_jax(cls_transfer_dirs):
    _, dirs = cls_transfer_dirs
    want, got = load_pair(dirs, "pc_pred_labels_test_set_13l.npy")
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data_type", CLS_DATA_TYPES)
def test_slice_run_and_evaluate_classifier_match_jax(cls_transfer_dirs, data_type):
    _, dirs = cls_transfer_dirs
    res = "attack_res/"
    folder, name = {
        "target": ("classifier_res_orig", "target_pc_recon_pred.npy"),
        "adversarial": ("classifier_res", "adversarial_pc_recon_pred.npy"),
        "source": ("defense_critical_res/classifier_res_orig", "source_pc_recon_pred.npy"),
        "before_defense": ("defense_critical_res/classifier_res",
                           "adversarial_pc_recon_pred.npy"),
        "after_defense": ("defense_critical_res/classifier_res", "defended_pc_recon_pred.npy"),
    }[data_type]
    for cls in CLASSES:
        want, got = load_pair(dirs, f"{res}{folder}/{cls}/{name}")
        assert got.dtype == want.dtype == np.int8 and got.shape == want.shape == (1, 8)
        np.testing.assert_array_equal(got, want)
    stats_folder = ("defense_critical_res/classifier_res" if data_type == "before_defense"
                    else folder)
    for ct in ("hit_target", "avoid_source"):
        texts = [open(osp.join(e, f"{res}{stats_folder}/over_classes/"
                               f"eval_stats_{data_type}_{ct}.txt")).read() for e in dirs]
        assert "over classes" in texts[0] and texts[1] == texts[0], ct


@pytest.mark.parametrize("kind", sorted(TRANSFER_KINDS))
def test_slice_transfer_matches_jax(cls_transfer_dirs, kind):
    d, dirs = cls_transfer_dirs
    name = TRANSFER_KINDS[kind][0].lower()
    loss = [np.load(osp.join(d, f"log/{p}_{kind}/eval/ae_loss_test_set_13l.npy"))
            for p in ("jax", "port")]
    np.testing.assert_allclose(loss[1], loss[0], rtol=1e-5)
    for cls in CLASSES:
        res = f"attack_res/transfer_res_{name}/{cls}/"
        want, got = load_pair(dirs, res + "transfer_metrics.npy")
        assert got.shape == want.shape == (1, 8, 4) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
        want, got = load_pair(dirs, res + "transferred_pc_recon.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    texts = [open(osp.join(e, f"attack_res/transfer_res_{name}/over_classes/"
                              "eval_stats.txt")).read() for e in dirs]
    assert "Tra" in texts[0] and texts[1] == texts[0]


EMD_ATTACK = ATTACK + ["--loss_dist_type", "pert"]


@pytest.fixture(scope="module")
def emd_slice_dirs(tmp_path_factory):
    from geometric_adv_tpu.data.synthetic import make_shapenet_like_dir
    from geometric_adv_tpu.data import PointCloudDataSet, load_dataset
    from geometric_adv_tpu.train import AETrainer, Configuration

    d = str(tmp_path_factory.mktemp("emd_slice"))
    make_shapenet_like_dir(osp.join(d, "data/tiny"), CLASSES, n_per_class=40,
                           n_points=64, seed=1)
    conf = Configuration(n_input=[64, 3], bneck_size=16, batch_size=10,
                         class_names=CLASSES, loss="emd", training_epochs=1,
                         saver_step=None, held_out_step=None)
    jax_ae, port_ae = "log/jax_emd", "log/port_emd"
    for ae in (jax_ae, port_ae):
        conf.train_dir = osp.join(d, ae)
        conf.save(osp.join(d, ae, "configuration"))
    train, _, _ = load_dataset(CLASSES, "train_set", osp.join(d, "data/tiny"))
    trainer = AETrainer(conf)  # flax init, seed 42, then one epoch of EMD
    trainer.train(PointCloudDataSet(train.point_clouds, init_shuffle=False), conf)
    trainer.save(osp.join(d, jax_ae), 1)
    bridge_checkpoint(trainer.state.params, trainer.state.batch_stats,
                      osp.join(d, port_ae), 1)
    with pytest.MonkeyPatch.context() as mp:
        run_jax_stages(mp, d, jax_ae, EMD_ATTACK)
        run_port_stages(mp, d, port_ae, EMD_ATTACK)
    return (osp.join(d, jax_ae, "eval"), osp.join(d, port_ae, "eval"))


def test_emd_slice_eval_and_indices_match_jax(emd_slice_dirs):
    for rel in ("latent_vectors_test_set_13l.npy", "ae_loss_test_set_13l.npy",
                "reconstructions_test_set_13l.npy"):
        want, got = load_pair(emd_slice_dirs, rel)
        assert got.shape == want.shape and got.dtype == want.dtype, rel
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=rel)
    for rel in ("sel_idx_rand_4_test_set_13l.npy",
                "chamfer_nn_idx_complete_test_set_13l.npy",
                "latent_nn_idx_test_set_13l.npy"):
        want, got = load_pair(emd_slice_dirs, rel)
        np.testing.assert_array_equal(got, want, err_msg=rel)


@pytest.mark.parametrize("cls", CLASSES)
def test_emd_slice_attack_matches_jax(emd_slice_dirs, cls):
    res = f"attack_res/{cls}/"
    want, got = load_pair(emd_slice_dirs, res + "adversarial_metrics.npy")
    assert got.shape == want.shape == (1, 8, 5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    for name in ("adversarial_pc_input.npy", "adversarial_pc_recon.npy",
                 "adversarial_pc_input_dists.npy"):
        want, got = load_pair(emd_slice_dirs, res + name)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def test_emd_slice_critical_replay_per_class(emd_slice_dirs, monkeypatch):
    """run_defense_critical --do_sanity_checks 1 replays get_reconstructions
    and get_loss_per_pc on each class's rows alone, as the JAX CLI does
    (geometric_adv_tpu/cli/run_defense_critical.py:79-94), against tst_ae's
    artifacts of the whole test set, at the reference's 1e-6 and 1e-7: the
    EMD victim's forward must not depend on the batch its clouds sit in.
    Every test cloud is a source here (4 a class), so that each one is
    replayed in a batch of another size than tst_ae's."""
    from geometric_adv_tpu_torch.cli import (
        evaluate_attack,
        get_dists_per_point,
        run_attack,
        run_defense_critical,
    )

    monkeypatch.setattr(port_core, "init_pert", jax_pert0)
    d = osp.dirname(osp.dirname(osp.dirname(emd_slice_dirs[1])))
    ae = "log/port_emd"
    a = ["--project_dir", d, "--ae_folder", ae, "--attack_pc_idx", f"{ae}/{SEL}"]
    cpu = ["--device", "cpu"]
    run_attack.main(a + cpu + ["--num_pc_for_attack", "4", "--num_pc_for_target", "1",
                               "--num_iterations", "2", "--num_iterations_thresh", "1",
                               "--loss_dist_type", "pert", "--output_folder_name",
                               "attack_every_source"])
    folder = ["--attack_folder", "attack_every_source"]
    get_dists_per_point.main(a + cpu + folder)
    evaluate_attack.main(a + ["--output_folder_name", "attack_every_source"])
    run_defense_critical.main(a + cpu + folder + ["--do_sanity_checks", "1"])
    metrics = np.load(osp.join(emd_slice_dirs[1], "attack_every_source",
                               "defense_critical_res", CLASSES[0],
                               "defense_metrics.npy"))
    assert metrics.shape == (1, 8, 4) and np.isfinite(metrics).all()


@pytest.mark.parametrize("loss", ["chamfer", "emd"])
def test_port_train_ae_cli_lowers_the_loss(tmp_path, loss):
    """The port's train_ae stage on the CPU: configuration, checkpoints and
    train_stats.txt as the JAX stage writes them, and a falling loss."""
    from geometric_adv_tpu_torch.cli import train_ae
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir
    from geometric_adv_tpu_torch.train.config import Configuration

    d = str(tmp_path)
    make_shapenet_like_dir(osp.join(d, "data/tiny"), ["sphere", "cube"],
                           n_per_class=40, n_points=64, seed=2)
    ae = "log/ae"
    train_ae.main(["--project_dir", d, "--device", "cpu", "--data_folder",
                   "data/tiny", "--n_points", "64", "--bneck_size", "16",
                   "--batch_size", "10", "--training_epochs", "5", "--loss", loss,
                   "--train_folder", ae])
    lines = open(osp.join(d, ae, "train_stats.txt")).read().splitlines()
    epochs = [ln.split("\t") for ln in lines if not ln.startswith("On Held_Out")]
    assert [int(e[0]) for e in epochs] == [1, 2, 3, 4, 5]
    assert all(len(e[1].split(".")[1]) == 9 and len(e[2].split(".")[1]) == 4
               for e in epochs)
    assert float(epochs[-1][1]) < float(epochs[0][1])
    assert sum(ln.startswith("On Held_Out: 0005") for ln in lines) == 1
    conf = Configuration.load(osp.join(d, ae, "configuration"))
    assert conf.loss == loss and conf.held_out_step == 5 and conf.saver_step == 50
    assert sorted(os.listdir(osp.join(d, ae, "checkpoints"))) == ["1.pt"]


@pytest.mark.slow
def test_port_replays_cli_pipeline_goldens(tmp_path, monkeypatch):
    """tests/test_cli_pipeline.py:50-120 with the port's stages after the
    JAX-trained victim, the defenses included, then the classifier's labels
    and both transfer AEs' test loss and transfer metrics from the JAX
    CLIs' checkpoints bridged (tests/test_cli_pipeline.py:145-227), against
    tests/golden/ at the bars above."""
    from geometric_adv_tpu.train import checkpoint as jax_ckpt

    d = str(tmp_path)
    ae = "log/autoencoder_victim"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for module, args in (
        ("make_synthetic_data", ["--data_folder", "data/tiny", "--class_names",
                                 *CLASSES, "--n_per_class", "40",
                                 "--n_points", "64"]),
        ("train_ae", ["--data_folder", "data/tiny", "--n_points", "64",
                      "--bneck_size", "16", "--batch_size", "10",
                      "--training_epochs", "3", "--train_folder", ae]),
    ):
        res = subprocess.run(
            [sys.executable, "-m", f"geometric_adv_tpu.cli.{module}",
             "--project_dir", d, *args],
            env=env, capture_output=True, text=True, timeout=600,
        )
        assert res.returncode == 0, res.stderr[-3000:]

    train_dir = osp.join(d, ae)
    epoch = jax_ckpt.latest_epoch(train_dir)
    tree = jax_ckpt.restore_checkpoint(train_dir, epoch)
    bridge_checkpoint(tree["params"], tree["batch_stats"], train_dir, epoch)
    run_port_stages(monkeypatch, d, ae)
    run_defenses(monkeypatch, d, ae, "port")

    ev = osp.join(train_dir, "eval")
    att = osp.join(ev, "attack_res", "sphere")

    def golden(name):
        return np.load(osp.join(GOLDEN_DIR, name))

    np.testing.assert_allclose(
        np.load(osp.join(ev, "latent_vectors_test_set_13l.npy")),
        golden("latent_vectors_test_set.npy"), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.load(osp.join(ev, "ae_loss_test_set_13l.npy")),
        golden("ae_loss_test_set.npy"), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np.load(osp.join(ev, "chamfer_nn_idx_complete_test_set_13l.npy")),
        golden("chamfer_nn_idx.npy"))
    np.testing.assert_array_equal(
        np.load(osp.join(ev, "latent_nn_idx_test_set_13l.npy")),
        golden("latent_nn_idx.npy"))
    np.testing.assert_allclose(
        np.load(osp.join(att, "adversarial_metrics.npy")),
        golden("adversarial_metrics_sphere.npy"), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.load(osp.join(att, "adversarial_pc_input_dists.npy")),
        golden("adversarial_pc_input_dists_sphere.npy"), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        np.load(osp.join(att, "analysis_results",
                         "source_target_norm_min_idx.npy")),
        golden("source_target_norm_min_idx_sphere.npy"))
    for defense in ("critical", "surface"):
        np.testing.assert_allclose(
            np.load(osp.join(att, "..", f"defense_{defense}_res", "sphere",
                             "defense_metrics.npy")),
            golden(f"defense_{defense}_metrics_sphere.npy"), rtol=2e-4, atol=1e-6)

    # the classifier and transfer goldens: the JAX CLIs train as
    # tests/test_cli_pipeline.py:145-227 does, their checkpoints are bridged
    # and the port's stages replay on the port's attack
    from geometric_adv_tpu_torch.classify import ClassifierTrainer
    from geometric_adv_tpu_torch.transfer import save_transfer_arch
    from geometric_adv_tpu_torch.utils.artifacts import load_data

    data = ["--ae_folder", ae, "--data_folder", "data/tiny", "--batch_size", "8"]
    for module, args in (
        ("train_classifier", data + ["--max_epoch", "2"]),
        ("train_transfer", data + ["--ae_type", "atlasnet", "--epochs", "2",
                                   "--number_points", "64"]),
        ("train_transfer", data + ["--ae_type", "foldingnet", "--epochs", "1"]),
    ):
        res = subprocess.run(
            [sys.executable, "-m", f"geometric_adv_tpu.cli.{module}",
             "--project_dir", d, *args],
            env=env, capture_output=True, text=True, timeout=600,
        )
        assert res.returncode == 0, res.stderr[-3000:]
    cls_dir = osp.join(d, "log/pointnet")
    bridge_tree(cls_dir, cls_dir, jax_ckpt.latest_epoch(cls_dir))
    labels = ClassifierTrainer(num_classes=len(CLASSES), device="cpu").restore(
        cls_dir).classify(load_data(ev, None, ["point_clouds_test_set"]))
    want = golden("pc_pred_labels_test_set.npy")
    assert labels.dtype == want.dtype
    np.testing.assert_array_equal(labels, want)
    sel = f"{ae}/{SEL}"
    for kind, (name, arch) in TRANSFER_KINDS.items():
        folder = f"log/{kind}_for_transfer"
        tdir = osp.join(d, folder)
        bridge_tree(tdir, tdir, jax_ckpt.latest_epoch(tdir))
        save_transfer_arch(tdir, kind, **arch)
        run_cli("port", "tst_transfer", ["--project_dir", d, "--ae_folder", ae,
                                         "--ae_type", kind, "--train_folder", folder],
                monkeypatch)
        run_cli("port", "run_transfer", ["--project_dir", d, "--ae_folder", ae,
                                         "--attack_pc_idx", sel, "--transfer_ae_type", name,
                                         "--transfer_ae_folder", folder], monkeypatch)
        np.testing.assert_allclose(
            np.load(osp.join(tdir, "eval", "ae_loss_test_set_13l.npy")),
            golden(f"transfer_test_loss_{kind}.npy"), rtol=1e-5)
        np.testing.assert_allclose(
            np.load(osp.join(att, "..", f"transfer_res_{name.lower()}", "sphere",
                             "transfer_metrics.npy")),
            golden(f"transfer_metrics_{kind}_sphere.npy"), rtol=2e-4, atol=1e-6)


@pytest.mark.slow
def test_port_replays_emd_pipeline_golden(tmp_path, monkeypatch):
    """tests/test_cli_pipeline.py:311-369 (EMD victim, default attack flags)
    with the port's stages after the JAX-trained victim. The target
    reconstruction columns (loss_adv, T-NRE, T-RE) hold at the slice bars
    (rtol 2e-4 / atol 1e-6). The input-distance columns (loss_dist, S-CD)
    are held at rtol 0.1: the golden's attack took its first steps on the
    JAX CPU sweep's cancelled float32 gradient of the EMD input distance
    (see the module docstring); the port's replay measured 4.6e-2 to 5.1e-2
    from them."""
    from geometric_adv_tpu.train import checkpoint as jax_ckpt

    d = str(tmp_path)
    ae = "log/autoencoder_emd"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for module, args in (
        ("make_synthetic_data", ["--data_folder", "data/tiny", "--class_names",
                                 "sphere", "cube", "--n_per_class", "40",
                                 "--n_points", "64"]),
        ("train_ae", ["--data_folder", "data/tiny", "--n_points", "64",
                      "--bneck_size", "16", "--batch_size", "10",
                      "--training_epochs", "2", "--loss", "emd",
                      "--train_folder", ae]),
    ):
        res = subprocess.run(
            [sys.executable, "-m", f"geometric_adv_tpu.cli.{module}",
             "--project_dir", d, *args],
            env=env, capture_output=True, text=True, timeout=600,
        )
        assert res.returncode == 0, res.stderr[-3000:]

    train_dir = osp.join(d, ae)
    epoch = jax_ckpt.latest_epoch(train_dir)
    tree = jax_ckpt.restore_checkpoint(train_dir, epoch)
    bridge_checkpoint(tree["params"], tree["batch_stats"], train_dir, epoch)
    attack = ["--num_pc_for_attack", "2", "--num_pc_for_target", "2",
              "--num_iterations", "4", "--num_iterations_thresh", "2"]
    run_port_stages(monkeypatch, d, ae, attack, "eval/sel_idx_rand_2_test_set_13l.npy",
                    per_class="2")
    got = np.load(osp.join(train_dir, "eval/attack_res/sphere/adversarial_metrics.npy"))
    want = np.load(osp.join(GOLDEN_DIR, "adversarial_metrics_emd_sphere.npy"))
    assert got.shape == want.shape == (1, 4, 5)
    target = [0, 3, 4]
    np.testing.assert_allclose(got[..., target], want[..., target], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got[..., 1:3], want[..., 1:3], rtol=0.1)
