"""The port's PointNet classifier (geometric_adv_tpu_torch/models/
pointnet_cls.py, classify/trainer.py) against the JAX package's, on the CPU,
from bridged weights (models/bridge.py, which walks trees of any depth).

Bars: eval logits rtol 1e-5 / atol 1e-5 (full and basic models);
``classifier_loss`` rtol 1e-6; the BN momentum schedule equal and the
learning rate equal to float32 rounding (rel 1e-6) at steps across two
staircase boundaries; three train steps with the JAX package's jitter and
dropout masks injected, the BN momentum changing at each: loss rtol 1e-5,
parameters atol 1e-5 and batch statistics rtol 1e-5 (atol 1e-5 of each
tensor's largest entry), as tests/test_torch_train.py holds the AE's, each
step from the JAX trainer's
state; the parameters whose true gradient is zero (the Dense biases that a
batch norm follows, those of the norms before a max) are left out, and so are the entries
whose gradient is within rounding of zero, where Adam's first steps move by
+-lr in the direction of the noise (at full width, a few of a million).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.classify.trainer import ClassifierTrainer as JaxTrainer
from geometric_adv_tpu.classify.trainer import bn_momentum_schedule as jax_bn_schedule
from geometric_adv_tpu.models.pointnet_cls import PointNetClassifier as JaxCls
from geometric_adv_tpu.models.pointnet_cls import classifier_loss as jax_loss
from geometric_adv_tpu_torch.classify.trainer import (
    ClassifierTrainer,
    bn_momentum_schedule,
)
from geometric_adv_tpu_torch.models.bridge import (
    adam_state_from_optax,
    state_dict_from_flax,
)
from geometric_adv_tpu_torch.models.pointnet_cls import (
    PointNetClassifier,
    classifier_loss,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed_variables(model, n, seed=0):
    """flax init with every parameter and statistic moved off its initial
    value (the T-Nets' zero transforms included), so that the bridge's
    mapping of every leaf and the transforms' products are exercised."""
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)), train=False)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * np.abs(rng.randn(*a.shape))).astype(np.float32),
        variables["batch_stats"])
    return params, stats


def clouds(b, n, seed):
    return np.random.RandomState(seed).rand(b, n, 3).astype(np.float32) - 0.5


@pytest.mark.parametrize("depth", [1, 3])
def test_bridge_walks_trees_of_any_depth(depth):
    """A leaf one level down (``params["conv1"]["kernel"]``) and three levels
    down (``params["transform_net1"]["tconv1"]["kernel"]``) land under the
    joined path, kernels transposed, statistics beside their scale; the
    optax moments follow the same names."""
    params, stats = perturbed_variables(JaxCls(num_classes=4), 16)
    sd = state_dict_from_flax(params, stats)
    path = ("conv1",) if depth == 1 else ("transform_net1", "tconv1")
    bn_path = ("conv1_bn",) if depth == 1 else ("transform_net1", "tbn1")

    def at(tree, keys):
        for k in keys:
            tree = tree[k]
        return tree

    name, bn = ".".join(path), ".".join(bn_path)
    np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(), at(params, path)["kernel"].T)
    np.testing.assert_array_equal(sd[f"{name}.bias"].numpy(), at(params, path)["bias"])
    np.testing.assert_array_equal(sd[f"{bn}.weight"].numpy(), at(params, bn_path)["scale"])
    np.testing.assert_array_equal(sd[f"{bn}.running_var"].numpy(), at(stats, bn_path)["var"])
    model = PointNetClassifier(num_classes=4)
    model.load_state_dict(sd)  # strict: every key of the port's tree, no other
    adam = adam_state_from_optax(7, params, jax.tree.map(np.square, params))
    assert set(adam) == {k for k, _ in model.named_parameters()}
    np.testing.assert_array_equal(adam[f"{name}.weight"]["exp_avg_sq"].numpy(),
                                  np.square(at(params, path)["kernel"]).T)
    assert float(adam[f"{name}.weight"]["step"]) == 7.0


@pytest.mark.parametrize("use_tnets", [True, False], ids=["full", "basic"])
def test_eval_logits_match_jax(use_tnets):
    jmodel = JaxCls(num_classes=5, use_tnets=use_tnets)
    params, stats = perturbed_variables(jmodel, 48, seed=3)
    x = clouds(4, 48, seed=4)
    want_logits, want_t = jmodel.apply({"params": params, "batch_stats": stats}, x)
    model = PointNetClassifier(num_classes=5, use_tnets=use_tnets)
    model.load_state_dict(state_dict_from_flax(params, stats))
    with torch.no_grad():
        logits, t = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), **TOL)


def test_classifier_loss_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(6, 5).astype(np.float32)
    labels = rng.randint(0, 5, 6).astype(np.int32)
    transform = (np.eye(64) + 0.1 * rng.randn(6, 64, 64)).astype(np.float32)
    want = float(jax_loss(logits, labels, transform))
    got = float(classifier_loss(*(torch.from_numpy(a) for a in (logits, labels, transform))))
    assert got == pytest.approx(want, rel=1e-6)


def test_schedules_match_jax():
    """The BN momentum equal, the learning rate equal to float32 rounding,
    across two staircase boundaries (batch 8, decay step 40: at steps 5
    and 10), and at the clips."""
    trainer = ClassifierTrainer(num_classes=3, batch_size=8,
                                decay_step=40, device="cpu")
    for step in (0, 4, 5, 6, 9, 10, 11, 400):
        assert bn_momentum_schedule(step, 8, 40.0) == float(jax_bn_schedule(step, 8, 40.0))
        assert trainer.bn_momentum(step) == float(jax_bn_schedule(step, 8, 40.0))
        # the JAX trainer's schedule (classify/trainer.py:94-99) at optax's
        # int32 count
        want = jnp.maximum(0.001 * 0.7 ** ((jnp.int32(step) * 8) // 40), 1e-5)
        assert trainer.learning_rate(step) == pytest.approx(float(want), rel=1e-6)
    assert trainer.bn_momentum(10 ** 6) == pytest.approx(0.99, rel=1e-7)
    assert trainer.learning_rate(10 ** 6) == pytest.approx(1e-5, rel=1e-7)


def jax_grads_and_masks(jt, momentum):
    """A jitted (state, x, labels, key) -> (the gradient of the JAX
    trainer's step loss (classify/trainer.py:171-183) as a port state dict,
    the two dropout keep masks its Dropout layers drew from ``key``). A mask
    is read off the layer's output; where its input is 0 (after the ReLU) it
    is set True, which changes neither the output nor, the ReLU's gradient
    being 0 there, any gradient."""
    import flax.linen as fnn

    def taken(module, _):
        return isinstance(module, fnn.Dropout) or module.name in ("fc1_bn", "fc2_bn")

    @jax.jit
    def run(state, x, labels, key):
        def loss_fn(params):
            (logits, transform), upd = jt.model.apply(
                {"params": params, "batch_stats": state.batch_stats}, x, train=True,
                bn_momentum=momentum(state.step), mutable=["batch_stats", "intermediates"],
                rngs={"dropout": key}, capture_intermediates=taken)
            return jax_loss(logits, labels, transform), upd["intermediates"]

        grads, inter = jax.grad(loss_fn, has_aux=True)(state.params)
        masks = [jnp.where(inter[bn]["__call__"][0] > 0, inter[dp]["__call__"][0] != 0, True)
                 for bn, dp in (("fc1_bn", "dp1"), ("fc2_bn", "dp2"))]
        return grads, masks

    def call(state, x, labels, key):
        grads, masks = run(state, x, labels, key)
        sd = state_dict_from_flax(np_tree(grads), np_tree(state.batch_stats))
        return sd, [np.array(m) for m in masks]

    return call


def zero_gradient_params(names):
    """Parameters whose true gradient is zero: the Dense biases that a batch
    norm follows (the norm cancels them), and the biases of the batch norms
    before each max over points (conv5_bn, the T-Nets' tbn3), whose channels
    reach the loss through the max and the next batch norm, which cancels a
    shift shared by the batch."""
    out = {"conv5_bn.bias", "transform_net1.tbn3.bias", "transform_net2.tbn3.bias"}
    for name in names:
        layer, _, leaf = name.rpartition(".")
        head, _, last = layer.rpartition(".")
        if leaf == "bias" and (last.startswith(("conv", "tconv", "tfc"))
                               or last in ("fc1", "fc2")):
            out.add(name)
    return out


def test_three_train_steps_match_jax():
    """Three steps of batch 8 with decay step 8, so that the BN momentum is
    0.5, 0.75, 0.875 and the learning rate 1e-3, 7e-4, 4.9e-4 over them,
    each from the JAX trainer's state (weights, statistics and Adam's
    moments and count bridged), with the JAX step's jitter and dropout masks.

    The gradients are held at atol 5e-4 of each tensor's largest entry (they
    agree to 2.1e-4 of it: fc1's, through the batch norm's backward over 8
    clouds). Adam's update is ~lr * g / |g| wherever |g| is
    far above its eps, so an entry whose gradient the two frameworks round
    to values more than 1% apart moves by up to +-lr either way: the
    parameters are held at atol 1e-5 on the other entries, and at most 2%
    of a tensor's entries may be such; the zero-gradient parameters are left
    out."""
    n, bs = 32, 8
    jt = JaxTrainer(num_classes=3, num_points=n, batch_size=bs, decay_step=bs)
    pt = ClassifierTrainer(num_classes=3, batch_size=bs, decay_step=bs,
                           device="cpu")
    rng = np.random.RandomState(0)
    momenta = []
    grads_and_masks = jax_grads_and_masks(
        jt, lambda step: jax_bn_schedule(step, bs, float(bs)))
    skipped = zero_gradient_params(dict(pt.model.named_parameters()))
    for step in range(3):
        pt.model.load_state_dict(state_dict_from_flax(np_tree(jt.state.params),
                                                      np_tree(jt.state.batch_stats)))
        if step:
            adam = jt.state.opt_state[0]
            pt.optimizer.state.clear()
            for name, p in pt.model.named_parameters():
                pt.optimizer.state[p] = adam_state_from_optax(
                    adam.count, np_tree(adam.mu), np_tree(adam.nu))[name]
        x = clouds(bs, n, seed=10 + step)
        x = x + np.clip(0.01 * rng.randn(*x.shape), -0.05, 0.05).astype(np.float32)
        labels = rng.randint(0, 3, bs).astype(np.int32)
        key = jax.random.PRNGKey(step)
        momenta.append(pt.bn_momentum(step))
        grads, masks = grads_and_masks(jt.state, x, labels, key)
        jt.state, jloss, jacc = jt._jit_train_step(jt.state, x, labels, key)
        ploss, pacc = pt._train_step(
            torch.from_numpy(x), torch.from_numpy(labels).long(),
            tuple(torch.from_numpy(m) for m in masks))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {step}")
        assert float(pacc) == float(jacc)
        want = state_dict_from_flax(np_tree(jt.state.params),
                                    np_tree(jt.state.batch_stats))
        got = pt.model.state_dict()
        params = dict(pt.model.named_parameters())
        for name, w in want.items():
            g, w = got[name].numpy(), w.numpy()
            if "running_" in name:
                # a batch mean of 256 values of either sign cancels: its
                # rounding is relative to the tensor's scale, not the entry
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                           err_msg=f"{name}, step {step}")
            elif name not in skipped:
                gj, gp = grads[name].numpy(), params[name].grad.numpy()
                np.testing.assert_allclose(gp, gj, rtol=0, atol=5e-4 * np.abs(gj).max(),
                                           err_msg=f"gradient of {name}, step {step}")
                noise = np.abs(gp - gj) > 1e-2 * np.abs(gj)
                assert noise.mean() <= 0.02, (name, step, noise.mean())
                np.testing.assert_allclose(g[~noise], w[~noise], atol=1e-5,
                                           err_msg=f"{name}, step {step}")
    assert momenta == [0.5, 0.75, 0.875]


def test_classify_and_checkpoint_round_trip(tmp_path):
    """classify: int8 labels, the first maximum on ties, batch-size
    independent; save/restore keeps weights, statistics, epoch and labels."""
    trainer = ClassifierTrainer(num_classes=4, batch_size=8, device="cpu")
    with torch.no_grad():  # logits tie between classes 1 and 3
        trainer.model.fc3.weight.zero_()
        trainer.model.fc3.bias.copy_(torch.tensor([0.0, 2.0, 1.0, 2.0]))
    pcs = clouds(10, 24, seed=6)
    pred = trainer.classify(pcs, batch_size=3)
    assert pred.dtype == np.int8 and (pred == 1).all()
    trainer = ClassifierTrainer(num_classes=4, batch_size=8, device="cpu")
    labels = np.arange(10) % 4
    stats = trainer.train(pcs, labels, epochs=2)
    assert [s[0] for s in stats] == [1, 2] and np.isfinite([s[1] for s in stats]).all()
    trainer.save(str(tmp_path))
    other = ClassifierTrainer(num_classes=4, batch_size=8, seed=9,
                              device="cpu").restore(str(tmp_path))
    assert other.epoch == 2
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    np.testing.assert_array_equal(other.classify(pcs), trainer.classify(pcs, batch_size=4))


def test_train_prints_eval_accuracy_as_jax(capsys):
    """``train(seed=, eval_data=)``: the eval accuracy line every 10 epochs,
    equal to the JAX trainer's on bridged weights. The training set is
    smaller than a batch, so no step runs and both print the accuracy of
    the same weights at epochs 10 and 20; a seed other than 0 draws
    another epoch stream."""
    n, bs = 32, 8
    jt = JaxTrainer(num_classes=3, num_points=n, batch_size=bs)
    params, stats = perturbed_variables(JaxCls(num_classes=3), n, seed=4)
    jt.state = jt.state.replace(params=params, batch_stats=stats)
    pt = ClassifierTrainer(num_classes=3, batch_size=bs, device="cpu")
    pt.model.load_state_dict(state_dict_from_flax(params, stats))
    train_x, train_y = clouds(bs - 1, n, seed=7), np.arange(bs - 1) % 3
    eval_x = clouds(24, n, seed=8)
    eval_y = np.asarray(jt.classify(eval_x))
    eval_y[::3] = (eval_y[::3] + 1) % 3  # an accuracy other than 0 and 1

    def eval_lines(train):
        train(train_x, train_y, epochs=20, seed=3, eval_data=(eval_x, eval_y))
        return [ln for ln in capsys.readouterr().out.splitlines() if "eval acc" in ln]

    want = eval_lines(jt.train)
    assert want == ["  eval acc: 0.6667"] * 2
    assert eval_lines(pt.train) == want

    def trained(**seed):
        trainer = ClassifierTrainer(num_classes=3, batch_size=bs, device="cpu")
        trainer.train(clouds(bs, n, seed=9), np.arange(bs) % 3, epochs=1, **seed)
        return trainer.model.state_dict()["fc3.weight"]

    assert torch.equal(trained(), trained(seed=0))
    assert not torch.equal(trained(), trained(seed=5))
