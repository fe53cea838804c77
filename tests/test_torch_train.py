"""AE training in the port (geometric_adv_tpu_torch/train, models/layers.py
BN train mode, data/augment.py) against the JAX package's, on the CPU.

Bars: BN outputs, gradients and updated statistics rtol 1e-5; the train
steps' losses rtol 1e-5, parameters atol 1e-5 and batch statistics rtol
1e-5 after three steps from bridged weights. The encoder's dense biases are
left out of the parameter check: the batch norm after each cancels them, so
their true gradient is zero and Adam's first step moves them by +-lr in the
direction of rounding noise (tests/test_trainer.py:96-100). The running
means see those biases (each batch mean includes the bias of its step), so
they are compared after each run's own bias history, weighted as the
momentum weights it, is taken out.
"""

import os.path as osp

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.train import AETrainer as JaxTrainer
from geometric_adv_tpu.train import Configuration as JaxConfiguration
from geometric_adv_tpu_torch.data.augment import device_augment
from geometric_adv_tpu_torch.data.datasets import PointCloudDataSet
from geometric_adv_tpu_torch.models.bridge import (
    adam_state_from_optax,
    state_dict_from_flax,
)
from geometric_adv_tpu_torch.models.layers import BatchNorm
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.train.trainer import AETrainer

TINY = dict(n_input=[64, 3], bneck_size=16, encoder_filters=[16, 32, 16],
            decoder_sizes=[32, 32], batch_size=8, learning_rate=0.005)


def tiny_clouds(n=24, n_points=64, seed=0):
    from geometric_adv_tpu_torch.data.synthetic import sample_shape

    rng = np.random.RandomState(seed)
    names = ["sphere", "cube", "torus"]
    return np.stack([sample_shape(names[i % 3], n_points, rng)
                     for i in range(n)]).astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def bridged_pair(loss, **kw):
    """A JAX trainer (flax init, seed 42) and a port trainer carrying its
    weights."""
    jconf = JaxConfiguration(**TINY, loss=loss, **kw)
    jt = JaxTrainer(jconf)
    pt = AETrainer(Configuration(**TINY, loss=loss, **kw), "cpu")
    pt.model.load_state_dict(state_dict_from_flax(
        np_tree(jt.state.params), np_tree(jt.state.batch_stats)))
    return jt, pt


def encoder_biases(jt, pt):
    """The encoder dense biases of both trainers now, [(jax, port)] per layer."""
    n_layers = len(TINY["encoder_filters"])
    jp = np_tree(jt.state.params)["encoder"]
    return [(np.array(jp[f"conv_{i}"]["bias"]),
             getattr(pt.model.encoder, f"conv_{i}").bias.detach().numpy().copy())
            for i in range(n_layers)]


def assert_params_match(jt, pt, bias_history, atol=1e-5, momentum=0.9):
    """Parameters at ``atol`` but the encoder biases; batch statistics at
    rtol 1e-5, the running means less the momentum-weighted biases of the
    steps in ``bias_history`` (biases before each step, oldest first)."""
    want = state_dict_from_flax(np_tree(jt.state.params),
                                np_tree(jt.state.batch_stats))
    got = pt.model.state_dict()
    steps = len(bias_history)
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name.startswith("encoder.conv_") and name.endswith(".bias"):
            continue  # sign noise, see the module docstring
        if name.endswith("running_mean"):
            layer = int(name.split(".")[1].split("_")[1])
            for k, biases in enumerate(bias_history):
                weight = (1 - momentum) * momentum ** (steps - 1 - k)
                w = w - weight * biases[layer][0]
                g = g - weight * biases[layer][1]
        if "running_" in name:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=atol, err_msg=name)


@pytest.mark.parametrize("shape", [(4, 32, 6), (50, 5)], ids=["points", "flat"])
def test_batchnorm_train_mode_matches_flax(shape):
    c = shape[-1]
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    mean0 = (0.1 * rng.randn(c)).astype(np.float32)
    var0 = (0.5 + rng.rand(c)).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(a, p):
        y, upd = bn.apply({"params": p, "batch_stats": variables["batch_stats"]},
                          a, mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, upd["batch_stats"])

    (_, (want_y, stats)), (want_gx, want_gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, variables["params"])

    port = BatchNorm(c, momentum=0.9).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = port(tx)
    (y * torch.from_numpy(gy)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(want_gp["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), **tol)
    before = port.running_mean.clone()
    port.eval()
    with torch.no_grad():
        frozen = port(tx)
    assert torch.equal(port.running_mean, before)  # eval mode updates nothing
    assert not torch.allclose(frozen, y)  # and uses the running statistics


@pytest.mark.parametrize("loss", ["chamfer", "emd"])
def test_three_train_steps_match_jax(loss):
    jt, pt = bridged_pair(loss)
    pcs = tiny_clouds(24)
    history = []
    for step in range(3):
        x = pcs[8 * step: 8 * step + 8]
        history.append(encoder_biases(jt, pt))
        jt.state, jloss, jrecon = jt._jit_train_step(jt.state, x, x)
        ploss, precon = pt._train_step(torch.from_numpy(x), torch.from_numpy(x))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(precon.numpy(), np.asarray(jrecon), atol=1e-5)
    assert_params_match(jt, pt, history)


def test_lr_schedule_matches_jax():
    kw = dict(exponential_decay=True, decay_steps=2, steps_per_epoch=3,
              learning_rate=0.01)
    jt = JaxTrainer(JaxConfiguration(**{**TINY, **kw}))
    pt = AETrainer(Configuration(**{**TINY, **kw}), "cpu")
    for step in range(0, 200, 7):
        assert pt.learning_rate(step) == pytest.approx(
            float(jt.lr_schedule(step)), rel=1e-6)
    assert pt.learning_rate(10_000) == 1e-5  # the floor
    assert AETrainer(Configuration(**TINY), "cpu").learning_rate(999) == 0.005


def test_device_augment_distributions():
    gen = torch.Generator().manual_seed(0)
    big = torch.zeros(8, 512, 3)
    noisy = device_augment(big, gen, gauss_mu=0.1, gauss_sigma=0.02)
    assert abs(noisy.mean().item() - 0.1) < 1e-3
    assert abs(noisy.std().item() - 0.02) < 1e-3
    shifted = device_augment(big + 1, gen, gauss_mu=0.25, gauss_sigma=0.0)
    assert torch.allclose(shifted, big + 1.25)

    b = torch.from_numpy(np.random.RandomState(1).randn(4, 32, 3).astype(np.float32))
    rot = device_augment(b, gen, z_rotate=True)
    assert torch.equal(rot[..., 2], b[..., 2])
    assert torch.allclose((rot[..., :2] ** 2).sum(-1), (b[..., :2] ** 2).sum(-1),
                          atol=1e-4)
    # one proper rotation for the whole batch, recovered from one point
    x0, y0, x1, y1 = b[0, 0, 0], b[0, 0, 1], rot[0, 0, 0], rot[0, 0, 1]
    r2 = x0 * x0 + y0 * y0
    ct, st = (x0 * x1 + y0 * y1) / r2, (x0 * y1 - y0 * x1) / r2
    mat = torch.tensor([[ct, st, 0.0], [-st, ct, 0.0], [0.0, 0.0, 1.0]])
    assert torch.allclose(rot, b @ mat, atol=1e-4)
    assert abs((ct * ct + st * st).item() - 1.0) < 1e-5
    thetas = [device_augment(b, gen, z_rotate=True)[0, 0, 0].item() for _ in range(4)]
    assert len(set(thetas)) == 4  # a new angle per call


def test_augmented_training_fits_the_augmented_batch(monkeypatch):
    """Non-denoising: the augmented batch is its own ground truth; denoising:
    the noisy feed reconstructs the clean original."""
    pcs = tiny_clouds(16)
    seen = []
    for denoising in (False, True):
        conf = Configuration(**TINY, gauss_augment={"mu": 5.0, "sigma": 0.0},
                             is_denoising=denoising, training_epochs=1,
                             saver_step=None, held_out_step=None)
        t = AETrainer(conf, "cpu")
        monkeypatch.setattr(t, "_train_step", lambda x, gt: (
            seen.append(float((x - gt).abs().mean())) or torch.zeros(()), None))
        t.train(PointCloudDataSet(pcs, init_shuffle=False))
    assert seen[:2] == [0.0, 0.0] and all(abs(v - 5.0) < 1e-5 for v in seen[2:])


def test_checkpoint_resume_equals_an_unbroken_run(tmp_path):
    data = PointCloudDataSet(tiny_clouds(24), init_shuffle=False)

    def conf(d, epochs):
        return Configuration(**TINY, training_epochs=epochs, saver_step=1,
                             held_out_step=None, train_dir=str(d),
                             gauss_augment={"mu": 0.0, "sigma": 0.01},
                             z_rotate=True)

    whole = AETrainer(conf(tmp_path / "a", 3), "cpu")
    stats = whole.train(data)
    assert [s[0] for s in stats] == [1, 2, 3]
    first = AETrainer(conf(tmp_path / "b", 1), "cpu")
    first.train(data)
    resumed = AETrainer(conf(tmp_path / "b", 2), "cpu", seed=7).restore(
        str(tmp_path / "b"))
    assert resumed.epoch == 1 and resumed._updates_done() == 3
    resumed.train(data)
    assert resumed.epoch == 3 and resumed._updates_done() == 9
    for (k, a), (_, b) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(whole.optimizer.state.values(), resumed.optimizer.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert osp.exists(tmp_path / "a" / "checkpoints" / "3.pt")


def test_adam_state_from_optax_takes_the_same_next_step():
    jt, pt = bridged_pair("chamfer")
    pcs = tiny_clouds(24)
    for step in range(2):
        x = pcs[8 * step: 8 * step + 8]
        jt.state, _, _ = jt._jit_train_step(jt.state, x, x)
    adam = jt.state.opt_state[0]  # optax.adam = chain(scale_by_adam, lr)
    pt.model.load_state_dict(state_dict_from_flax(
        np_tree(jt.state.params), np_tree(jt.state.batch_stats)))
    pt.set_adam_state(adam_state_from_optax(
        np.asarray(adam.count), np_tree(adam.mu), np_tree(adam.nu)))
    assert pt._updates_done() == 2
    x = pcs[16:24]
    history = [encoder_biases(jt, pt)]
    jt.state, jloss, _ = jt._jit_train_step(jt.state, x, x)
    ploss, _ = pt._train_step(torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    assert_params_match(jt, pt, history, atol=1e-6)
