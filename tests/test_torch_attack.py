"""The port's attack (geometric_adv_tpu_torch/attack/core.py) against the JAX
package's ``attack_batch`` on the tiny victim of tests/test_attack.py, with
the JAX weights bridged into the port and JAX's ``init_pert`` injected.

Bars (tests/test_attack.py:116-118): metrics rtol 2e-4 / atol 1e-6, clouds
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.attack.core import _tf_adam_update as jax_adam
from geometric_adv_tpu.attack.core import attack_batch as jax_attack_batch
from geometric_adv_tpu.attack.core import init_pert as jax_init_pert
from geometric_adv_tpu.attack.core import pert_losses as jax_pert_losses
from geometric_adv_tpu.models import PointNetAE as JaxAE
from geometric_adv_tpu_torch.attack import core
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE


def tiny_victims(n=32, bneck=8, seed=0):
    """tests/test_attack.py:28-42's victim in both frameworks."""
    jmodel = JaxAE(n_points=n, bneck_size=bneck, encoder_filters=[16, bneck],
                   decoder_sizes=[16, 16])
    variables = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)), train=False
    )
    encode = jax.jit(lambda x: jmodel.apply(
        variables, x, train=False, method=JaxAE.encode))
    decode = jax.jit(lambda z: jmodel.apply(
        variables, z, train=False, method=JaxAE.decode))
    model = PointNetAE(n_points=n, bneck_size=bneck, encoder_filters=[16, bneck],
                       decoder_sizes=[16, 16])
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]),
    ))
    return encode, decode, model.eval().requires_grad_(False)


CASES = {
    "chamfer": dict(weights=[1.0], kw={}),
    "two_weights": dict(weights=[0.5, 2.0], kw={}),
    "latent_pert": dict(weights=[1.0], kw=dict(loss_adv_type="latent",
                                               loss_dist_type="pert")),
    "max_point_dist": dict(weights=[1.0], kw=dict(max_point_dist_weight=0.5)),
    "emd": dict(weights=[0.5, 2.0], kw=dict(ae_loss_type="emd", loss_dist_type="pert")),
    # per-example weights [W, B], the binary-search variant's
    "per_example_weights": dict(weights=[[0.5, 1.0, 4.0], [2.0, 0.1, 1.0]], kw={}),
    "per_example_by_loss_dist": dict(weights=[[10.0, 3.0, 0.5]],
                                     kw=dict(track_by="loss_dist")),
    "track_by_loss_dist": dict(weights=[0.5, 2.0], kw=dict(track_by="loss_dist")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_attack_batch_matches_jax(case):
    weights, kw = CASES[case]["weights"], CASES[case]["kw"]
    encode, decode, model = tiny_victims()
    rng = np.random.RandomState(42)
    b, n = 3, 32
    x = rng.rand(b, n, 3).astype(np.float32)
    gt = rng.rand(b, n, 3).astype(np.float32)
    target_z = np.asarray(encode(gt))
    loss_ref = rng.rand(b).astype(np.float32) + 0.5
    it = dict(num_iterations=20, num_iterations_thresh=12, learning_rate=0.01)

    want = jax_attack_batch(encode, decode, x, target_z, gt, loss_ref,
                            np.asarray(weights, np.float32), **it, **kw)
    pert0 = np.asarray(jax_init_pert((b, n, 3)))
    t = torch.tensor
    got = core.attack_batch(model.encode, model.decode, t(x), t(target_z),
                            t(gt), t(loss_ref), weights, pert0=t(pert0), **it,
                            **kw)
    assert got.metrics.shape == (len(weights), b, 5)
    np.testing.assert_allclose(got.metrics, np.asarray(want.metrics),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got.pc_input, np.asarray(want.pc_input), atol=1e-5)
    np.testing.assert_allclose(got.pc_recon, np.asarray(want.pc_recon), atol=1e-5)


def test_attack_runner_batches_and_matches_single_call():
    """AttackRunner splits the grid into calls of ``batch_size`` pairs; the
    rows are independent, so the split changes nothing."""
    from geometric_adv_tpu_torch.train.config import Configuration

    _, _, model = tiny_victims()
    rng = np.random.RandomState(1)
    b, n = 5, 32
    x, gt = (rng.rand(b, n, 3).astype(np.float32) for _ in range(2))
    tz = model.encode(torch.from_numpy(gt)).numpy()
    ref = np.ones(b, np.float32)
    pert0 = (rng.randn(b, n, 3) * 1e-7).astype(np.float32)
    conf = Configuration(n_input=[n, 3], num_iterations=6,
                         num_iterations_thresh=3, dist_weight_list=[1.0, 2.0])
    runner = core.AttackRunner(model, conf, "cpu")
    whole = runner.attack(x, tz, gt, ref, batch_size=b, pert0=pert0)
    split = runner.attack(x, tz, gt, ref, batch_size=2, pert0=pert0)
    assert whole.metrics.shape == (2, b, 5)
    assert whole.pc_input.shape == (2, b, n, 3)
    for a, c in zip(whole, split):
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)


def test_runner_rejects_unported_modes():
    """An unknown loss raises, and so does chamfer_refresh with an EMD
    victim; an EMD victim's runner builds and runs, its metrics finite and
    its T-RE the victim's EMD."""
    from geometric_adv_tpu_torch.ops.emd import emd_loss_fused
    from geometric_adv_tpu_torch.train.config import Configuration

    _, _, model = tiny_victims()
    with pytest.raises(ValueError, match="requires the chamfer AE loss"):
        core.AttackRunner(model, Configuration(loss="emd", chamfer_refresh=5), "cpu")
    with pytest.raises(ValueError, match="unknown ae loss"):
        core.AttackRunner(model, Configuration(loss="hausdorff"), "cpu")
    conf = Configuration(loss="emd", n_input=[32, 3], num_iterations=4,
                         num_iterations_thresh=2)
    runner = core.AttackRunner(model, conf, "cpu")
    rng = np.random.RandomState(3)
    x, gt = (rng.rand(2, 32, 3).astype(np.float32) for _ in range(2))
    tz = model.encode(torch.from_numpy(gt)).numpy()
    out = runner.attack(x, tz, gt, np.ones(2, np.float32))
    assert out.metrics.shape == (1, 2, 5) and np.isfinite(out.metrics).all()
    recon = torch.from_numpy(out.pc_recon[0])
    np.testing.assert_allclose(out.metrics[0, :, 4],
                               emd_loss_fused(recon, torch.from_numpy(gt)).numpy(),
                               rtol=1e-6)


def test_adam_and_pert_losses_match_jax():
    rng = np.random.RandomState(0)
    g, m, v = (rng.randn(4, 16, 3).astype(np.float32) for _ in range(3))
    v = np.abs(v)
    for t in (1, 7, 400):
        js, jm, jv = jax_adam(g, m, v, jnp.float32(t), 0.01)
        ts, tm, tv = core._tf_adam_update(
            torch.from_numpy(g), torch.from_numpy(m), torch.from_numpy(v), t, 0.01
        )
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for got, want in zip(core.pert_losses(torch.from_numpy(g)), jax_pert_losses(g)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_init_pert_is_seeded_truncated_normal():
    a = core.init_pert((64, 128, 3), "cpu")
    b = core.init_pert((64, 128, 3), "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, core.init_pert((64, 128, 3), "cpu", seed=56))
    assert a.abs().max().item() <= 2e-7
    # std of a standard normal truncated at +/-2 sigma is 0.8796
    assert a.std().item() == pytest.approx(0.8796e-7, rel=0.02)


@pytest.fixture(scope="module")
def tiny_project(tmp_path_factory):
    """A chamfer victim trained one epoch by the port's train_ae, its eval
    dump and pair indices."""
    import os.path as osp

    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack, train_ae, tst_ae
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir

    d = str(tmp_path_factory.mktemp("attack_cli"))
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


@pytest.mark.parametrize("flags", [
    ["--encoder_vjp", "sparse"],
    ["--matmul_precision", "bfloat16"],
])
def test_run_attack_rejects_unported_flag_values(flags, tiny_project):
    """The two values the port once rejected now run: ``--encoder_vjp
    sparse`` takes the sparse backward (its counter moves) and
    ``--matmul_precision bfloat16`` computes full float32 on the CPU, as
    XLA:CPU does; attack_impl.json records both (the ``--encoder_vjp`` flag
    under ``encoder_vjp``, the path taken under ``encoder_vjp_path``), and
    the TF32 flags are as they were after the stage. An unknown precision
    raises."""
    import json
    import os.path as osp

    from geometric_adv_tpu_torch.cli import run_attack
    from geometric_adv_tpu_torch.models import sparse_encode

    d, ae = tiny_project
    calls = sparse_encode.BACKWARD_CALLS
    flags_before = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
    out = "attack_" + flags[1]
    run_attack.main(["--project_dir", d, "--device", "cpu", "--ae_folder", ae,
                     "--attack_pc_idx", f"{ae}/eval/sel_idx_rand_2_test_set_13l.npy",
                     "--num_pc_for_attack", "2", "--num_pc_for_target", "1",
                     "--num_iterations", "6", "--num_iterations_thresh", "3",
                     "--output_folder_name", out, *flags])
    res = osp.join(d, ae, "eval", out)
    impl = json.load(open(osp.join(res, "attack_impl.json")))
    sparse = flags[1] == "sparse"
    # the flag under the JAX stage's key, the path taken under the port's
    assert impl["encoder_vjp"] == ("sparse" if sparse else "auto")
    assert impl["encoder_vjp_path"] == ("sparse" if sparse else "dense")
    assert (sparse_encode.BACKWARD_CALLS > calls) == sparse
    assert impl["matmul_precision"] == (None if sparse else "bfloat16")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags_before
    metrics = np.load(osp.join(res, "sphere", "adversarial_metrics.npy"))
    assert metrics.shape == (1, 2, 5) and np.isfinite(metrics).all()
    with pytest.raises(ValueError, match="matmul_precision"):
        run_attack.main(["--attack_pc_idx", "unused.npy", "--device", "cpu",
                         "--matmul_precision", "fp8"])


def test_binary_search_attack_matches_jax(monkeypatch):
    """binary_search_attack on the bridged tiny victim with JAX's init_pert
    draw: the final per-example weights equal, best_dist at rtol 2e-4, the
    rest at the attack's bars."""
    from geometric_adv_tpu.attack.core import binary_search_attack as jax_bsa

    monkeypatch.setattr(core, "init_pert", lambda shape, device, stddev=1e-7, seed=55:
                        torch.tensor(np.asarray(jax_init_pert(shape, stddev, seed))))
    encode, decode, model = tiny_victims()
    rng = np.random.RandomState(5)
    x, gt = (rng.rand(3, 32, 3).astype(np.float32) for _ in range(2))
    tz = np.array(encode(gt))
    kw = dict(binary_search_step=4, num_iterations=12, init_dist_weight=10.0,
              upper_bound_dist_weight=100.0)
    want = [np.asarray(a) for a in jax_bsa(encode, decode, x, tz, gt, **kw)]
    got = core.binary_search_attack(model.encode, model.decode, x, tz, gt,
                                    device="cpu", **kw)
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=0)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


def test_attack_batch_rejects_mismatched_weights():
    _, _, model = tiny_victims()
    x = torch.rand(3, 32, 3)
    with pytest.raises(ValueError, match="dist_weights of shape"):
        core.attack_batch(model.encode, model.decode, x, model.encode(x), x,
                          torch.ones(3), [[1.0, 2.0]], num_iterations=2)
    with pytest.raises(ValueError, match="unknown track_by"):
        core.attack_batch(model.encode, model.decode, x, model.encode(x), x,
                          torch.ones(3), [1.0], num_iterations=2, track_by="s_cd")
