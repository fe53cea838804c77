"""The port's frozen-assignment attack (``chamfer_refresh``), its fused
route and the runner's routing, against the JAX package on the CPU.

The tiny victims of tests/test_torch_attack.py (the JAX weights bridged into
the port), with JAX's ``init_pert`` draw injected. Bars (tests/test_attack.py:
116-118, 544-580, 617-644): metrics rtol 2e-4 / atol 1e-6, clouds atol 1e-5;
the frozen terms at a refresh equal the exact loss at rtol 1e-6 / atol 1e-7
and its gradient at rtol 1e-5 / atol 1e-7.
"""

import json
import os.path as osp

import numpy as np
import pytest
import torch

from geometric_adv_tpu.attack.core import attack_batch as jax_attack_batch
from geometric_adv_tpu.attack.core import init_pert as jax_init_pert
from geometric_adv_tpu_torch.attack import core
from geometric_adv_tpu_torch.ops import chamfer as tchamfer
from geometric_adv_tpu_torch.train.config import Configuration
from test_torch_attack import tiny_victims

METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
CLOUD_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_calibration_cache():
    core._CHAMFER_CALIB_CACHE.clear()
    yield
    core._CHAMFER_CALIB_CACHE.clear()


def attack_inputs(seed=42, b=3, n=32):
    encode, decode, model = tiny_victims()
    rng = np.random.RandomState(seed)
    x = rng.rand(b, n, 3).astype(np.float32)
    gt = rng.rand(b, n, 3).astype(np.float32)
    target_z = np.asarray(encode(gt))
    loss_ref = rng.rand(b).astype(np.float32) + 0.5
    pert0 = np.asarray(jax_init_pert((b, n, 3)))
    return encode, decode, model, (x, target_z, gt, loss_ref), pert0


def port_attack(model, args, pert0, weights=(1.0,), **kw):
    t = torch.tensor
    x, tz, gt, ref = args
    return core.attack_batch(model.encode, model.decode, t(x), t(tz), t(gt), t(ref),
                             list(weights), pert0=t(pert0), **kw)


def assert_outputs_close(got, want):
    np.testing.assert_allclose(got.metrics, np.asarray(want.metrics), **METRIC_TOL)
    np.testing.assert_allclose(got.pc_input, np.asarray(want.pc_input), **CLOUD_TOL)
    np.testing.assert_allclose(got.pc_recon, np.asarray(want.pc_recon), **CLOUD_TOL)


@pytest.mark.parametrize("n,m", [(40, 24), (24, 40)])
def test_frozen_terms_at_a_refresh_equal_the_exact_loss(n, m):
    rng = np.random.RandomState(4)
    b = 3
    x1 = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32) - 0.5)
    x2 = torch.from_numpy(rng.rand(b, m, 3).astype(np.float32) - 0.5)
    _, d2, nn1, snn1, cnt1 = tchamfer.chamfer_frozen_payloads(x1, x2)
    p = {"nn1": nn1, "r": snn1 - cnt1[..., None] * x1, "cnt": cnt1,
         "d2sum0": d2.sum(-1), "x1_0": x1}

    def frozen(z):
        d1, mean_d2 = core._frozen_chamfer_terms(z, p, m)
        return d1.mean(-1) + mean_d2

    def exact(z):
        return tchamfer.chamfer_loss_per_pc(z, x2)

    grads = []
    for loss in (frozen, exact):
        z = x1.clone().requires_grad_(True)
        value = loss(z)
        value.sum().backward()
        grads.append((value.detach().numpy(), z.grad.numpy()))
    np.testing.assert_allclose(grads[0][0], grads[1][0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("refresh,iters", [(1, (20, 12)), (8, (30, 15))])
def test_frozen_attack_matches_jax(refresh, iters):
    """Period 1, and period 8 over 31 steps: three chunks of 8 and a
    remainder chunk of 7."""
    encode, decode, model, args, pert0 = attack_inputs()
    it = dict(num_iterations=iters[0], num_iterations_thresh=iters[1],
              learning_rate=0.01)
    want = jax_attack_batch(encode, decode, *args, np.asarray([1.0], np.float32),
                            chamfer_refresh=refresh, **it)
    got = port_attack(model, args, pert0, chamfer_refresh=refresh, **it)
    assert got.metrics.shape == (1, 3, 5)
    assert_outputs_close(got, want)


def test_frozen_attack_refresh_1_matches_the_exact_attack():
    _, _, model, args, pert0 = attack_inputs(seed=5)
    it = dict(num_iterations=20, num_iterations_thresh=12, weights=(0.5, 2.0))
    exact = port_attack(model, args, pert0, **it)
    frozen = port_attack(model, args, pert0, chamfer_refresh=1, **it)
    assert_outputs_close(frozen, exact)


def test_frozen_mode_rejects_the_emd_loss():
    _, _, model, args, pert0 = attack_inputs()
    with pytest.raises(ValueError, match="chamfer"):
        port_attack(model, args, pert0, num_iterations=2, num_iterations_thresh=1,
                    ae_loss_type="emd", chamfer_refresh=4)
    with pytest.raises(ValueError, match="chamfer"):
        core.AttackRunner(model, Configuration(loss="emd", chamfer_refresh=4), "cpu")


def test_runner_frozen_mode_skips_calibration(monkeypatch):
    """conf.chamfer_refresh > 0: attack_mode records the period, nothing is
    calibrated even where the runner would calibrate, and the outputs stay
    near the exact runner's (tests/test_attack.py:697-733's bars)."""
    _, _, model = tiny_victims()
    monkeypatch.setattr(core, "_on_cuda_device", lambda device: True)
    conf = Configuration(n_input=[32, 3], num_iterations=10, num_iterations_thresh=2,
                         dist_weight_list=[1.0], chamfer_refresh=4)
    runner = core.AttackRunner(model, conf, "cpu")
    assert runner.attack_mode == "frozen-4" and runner.chamfer_method == "auto"
    assert not core._CHAMFER_CALIB_CACHE
    conf_exact = Configuration(**{**conf.to_dict(), "chamfer_refresh": 0})
    exact_runner = core.AttackRunner(model, conf_exact, "cpu", chamfer_impl="composed")
    assert exact_runner.attack_mode == "composed"
    rng = np.random.RandomState(8)
    x, gt = (rng.rand(4, 32, 3).astype(np.float32) - 0.5 for _ in range(2))
    tz, ref = np.zeros((4, 8), np.float32), np.ones(4, np.float32)
    out_f = runner.attack(x, tz, gt, ref)
    out_e = exact_runner.attack(x, tz, gt, ref)
    np.testing.assert_allclose(out_f.metrics, out_e.metrics, rtol=0.05, atol=1e-4)


@pytest.mark.parametrize("weights", [(1.0,), (0.5, 2.0)])
def test_fused_attack_matches_jax(weights):
    """chamfer_method="fused" runs K5's plain version inside the fused
    Function on the CPU; the JAX package's CPU route is composed."""
    encode, decode, model, args, pert0 = attack_inputs(seed=9)
    it = dict(num_iterations=20, num_iterations_thresh=12, learning_rate=0.01)
    want = jax_attack_batch(encode, decode, *args, np.asarray(weights, np.float32),
                            **it)
    got = port_attack(model, args, pert0, weights, chamfer_method="fused", **it)
    assert_outputs_close(got, want)


def test_calibration_machinery(monkeypatch):
    """tests/test_attack.py:414-482 on the port: the calibration returns a
    bool and caches it per (victim, shape, config, batch); a cached value
    is not measured again; victim signatures key apart. The runner
    calibrates only where the device gate says CUDA, and never when a route
    is forced."""
    _, _, model = tiny_victims()
    monkeypatch.setattr(core, "_CALIB_BATCH", 2)
    monkeypatch.setattr(core, "_CALIB_ITERS", 2)
    monkeypatch.setattr(core, "_CALIB_REPS", 1)
    conf = Configuration(n_input=[32, 3], bneck_size=8, num_iterations=5,
                         num_iterations_thresh=1, dist_weight_list=[1.0])
    cpu = torch.device("cpu")
    decision = core._calibrate_chamfer_impl(model.encode, model.decode, conf, cpu)
    assert isinstance(decision, bool)
    assert len(core._CHAMFER_CALIB_CACHE) == 1
    key = next(iter(core._CHAMFER_CALIB_CACHE))
    core._CHAMFER_CALIB_CACHE[key] = not decision
    assert core._calibrate_chamfer_impl(model.encode, model.decode, conf,
                                        cpu) == (not decision)
    core._calibrate_chamfer_impl(model.encode, model.decode, conf, cpu, ("a",))
    core._calibrate_chamfer_impl(model.encode, model.decode, conf, cpu, ("b",))
    assert len(core._CHAMFER_CALIB_CACHE) == 3
    core._CHAMFER_CALIB_CACHE.clear()

    assert core.AttackRunner(model, conf, "cpu").chamfer_method == "auto"
    assert not core._CHAMFER_CALIB_CACHE
    monkeypatch.setattr(core, "_on_cuda_device", lambda device: True)
    for impl in ("fused", "composed"):
        assert core.AttackRunner(model, conf, "cpu", chamfer_impl=impl).attack_mode == impl
    assert not core._CHAMFER_CALIB_CACHE
    runner = core.AttackRunner(model, conf, "cpu", batch_size=3)
    assert runner.chamfer_method in ("fused", "composed")
    (key,) = core._CHAMFER_CALIB_CACHE
    assert key[-1] == 3  # measured at the runner's own batch
    core._CHAMFER_CALIB_CACHE.clear()
    assert runner.calibration_seconds > 0
    core._CHAMFER_CALIB_CACHE.clear()
    big = Configuration(n_input=[2049, 3], dist_weight_list=[1.0])
    big_runner = core.AttackRunner(model, big, "cpu")
    assert big_runner.chamfer_method == "auto" and big_runner.calibration_seconds == 0
    assert not core._CHAMFER_CALIB_CACHE
    with pytest.raises(ValueError):
        core.AttackRunner(model, conf, "cpu", chamfer_impl="mxu")


@pytest.fixture(scope="module")
def tiny_project(tmp_path_factory):
    """A chamfer victim trained one epoch by the port's train_ae, its eval
    dump and pair indices."""
    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack, train_ae, tst_ae
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir

    d = str(tmp_path_factory.mktemp("frozen_cli"))
    ae = "log/ae"
    make_shapenet_like_dir(osp.join(d, "data/tiny"), ["sphere", "cube"], 30, 64)
    c = ["--project_dir", d, "--device", "cpu"]
    train_ae.main(c + ["--data_folder", "data/tiny", "--n_points", "64",
                       "--bneck_size", "16", "--batch_size", "10",
                       "--training_epochs", "1", "--train_folder", ae])
    tst_ae.main(c + ["--data_folder", "data/tiny", "--train_folder", ae])
    prepare_indices_for_attack.main(c + [
        "--ae_folder", ae, "--get_rand_idx", "1", "--get_latent_nn_idx", "1",
        "--get_chamfer_nn_idx", "1", "--num_instance_per_class", "2"])
    return d, ae


@pytest.mark.parametrize("flags,mode,method", [
    (["--chamfer_refresh", "5"], "frozen-5", "auto"),
    (["--chamfer_impl", "fused"], "fused", "fused"),
    ([], "calibrated", "calibrated"),
])
def test_run_attack_cli_writes_its_routing(tiny_project, flags, mode, method,
                                           monkeypatch):
    """The routing in attack_impl.json; with the CUDA gate monkeypatched the
    runner calibrates at the batch each attack call gets: the class's pair
    grid of 2 sources x 1 target x 1 other class."""
    from geometric_adv_tpu_torch.cli import run_attack

    d, ae = tiny_project
    out = "attack_" + mode
    if mode == "calibrated":
        monkeypatch.setattr(core, "_CALIB_ITERS", 2)
        monkeypatch.setattr(core, "_CALIB_REPS", 1)
        monkeypatch.setattr(core, "_on_cuda_device", lambda device: True)
    run_attack.main(["--project_dir", d, "--device", "cpu", "--ae_folder", ae,
                     "--attack_pc_idx", f"{ae}/eval/sel_idx_rand_2_test_set_13l.npy",
                     "--num_pc_for_attack", "2", "--num_pc_for_target", "1",
                     "--num_iterations", "6", "--num_iterations_thresh", "3",
                     "--output_folder_name", out, *flags])
    res = osp.join(d, ae, "eval", out)
    impl = json.load(open(osp.join(res, "attack_impl.json")))
    assert impl["batch_size"] == 2
    if mode == "calibrated":
        assert impl["chamfer_method"] in ("fused", "composed")
        assert impl["attack_mode"] == impl["chamfer_method"]
        (key,) = core._CHAMFER_CALIB_CACHE
        assert key[-1] == 2 and impl["calibration_seconds"] > 0
    else:
        assert impl["attack_mode"] == mode and impl["chamfer_method"] == method
        assert impl["calibration_seconds"] == 0
    assert impl["chamfer_refresh"] == (5 if mode == "frozen-5" else 0)
    metrics = np.load(osp.join(res, "sphere", "adversarial_metrics.npy"))
    assert metrics.shape == (1, 2, 5) and np.isfinite(metrics).all()
    with pytest.raises(ValueError, match="chamfer_refresh"):
        run_attack.main(["--project_dir", d, "--device", "cpu", "--ae_folder", ae,
                         "--attack_pc_idx", "unused.npy", "--chamfer_refresh", "-1"])

