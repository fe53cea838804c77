"""The port's attack slice end to end against the JAX package, on the CPU.

Quick tier: one tiny synthetic dataset (3 classes x 40 clouds x 64 points)
and one JAX-initialised victim (bneck 16, as tests/test_cli_pipeline.py:
58-64) bridged into a port checkpoint. The JAX stage CLIs and the port's
(``--device cpu``) then run
tst_ae -> prepare_indices_for_attack -> run_attack (5 iterations) ->
get_dists_per_point -> evaluate_attack in-process on the same data, the
port's attack with JAX's ``init_pert`` draw injected. Bars: latents and AE
loss 1e-5; chamfer matrix 1e-7; index artifacts exact; attack metrics rtol
2e-4 / atol 1e-6 and clouds 1e-5 (tests/test_attack.py:116-118).

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

Slow tier: tests/test_cli_pipeline.py:50-102 and its EMD leg (:311-369)
replayed with the port's stages from the JAX-trained tiny victims, against
tests/golden/.
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
        run_port_stages(mp, d, port_ae)
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
    """tests/test_cli_pipeline.py:50-102 with the port's stages after the
    JAX-trained victim, against tests/golden/ at the bars above."""
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
