"""The port's transfer AEs (geometric_adv_tpu_torch/models/{atlasnet,
foldingnet}.py, transfer/trainers.py) against the JAX package's, on the CPU,
from bridged weights.

Bars: eval reconstructions atol 1e-5 (AtlasNet at narrow widths, both
templates, two primitives; FoldingNet at its fixed widths); ``graph_features``
on a cloud with duplicate points: neighbour indices equal, covariances within
1e-6; three train steps of each trainer (AtlasNet with the JAX step's random
template injected), each from the JAX trainer's state (weights, statistics
and Adam's moments bridged): loss rtol 1e-5, batch statistics rtol 1e-5
(atol 1e-4 of each tensor's largest entry: a batch mean cancels; measured
2.8e-5, AtlasNet's decoder_0.bn1 after the first step), and the
parameters atol 1e-5 on the entries where the two frameworks' gradients
agree within 1%, which must be at least 90% of the step's entries
(measured 92-99.9%). Elsewhere Adam's normalised step moves by up to +-lr
with the rounding: some gradient entries, those near a cancellation, agree
only to a few %. The steps train on the synthetic dataset's shapes, a
class a cloud. Parameters whose true gradient is
zero are left out: the Dense biases that a batch norm follows and the biases
of the norms whose shift the next norm cancels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.models import atlasnet as jax_atlas
from geometric_adv_tpu.models import foldingnet as jax_fold
from geometric_adv_tpu.ops import chamfer_loss_per_pc as jax_chamfer
from geometric_adv_tpu.transfer.trainers import AtlasNetTrainer as JaxAtlas
from geometric_adv_tpu.transfer.trainers import FoldingNetTrainer as JaxFold
from geometric_adv_tpu_torch.models import atlasnet, foldingnet
from geometric_adv_tpu_torch.models.bridge import (
    adam_state_from_optax,
    state_dict_from_flax,
)
from geometric_adv_tpu_torch.transfer.trainers import AtlasNetTrainer, FoldingNetTrainer


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * np.abs(rng.randn(*a.shape))).astype(np.float32),
        variables["batch_stats"])
    return params, stats


def shapes(b, n, seed):
    """The synthetic dataset's clouds, a different class each: the clouds a
    trainer sees. (Uniform cubes give a batch whose global features barely
    differ, and a batch norm over them amplifies either framework's
    rounding.)"""
    from geometric_adv_tpu_torch.data.synthetic import sample_shape

    rng = np.random.RandomState(seed)
    names = ["sphere", "cube", "torus", "cone", "cylinder", "helix"]
    return np.stack([sample_shape(names[i % 6], n, rng) for i in range(b)])


def clouds(b, n, seed, dup=False):
    x = np.random.RandomState(seed).rand(b, n, 3).astype(np.float32) - 0.5
    if dup:  # duplicates: "self" is whichever copy the tie rule puts first
        x[:, 5] = x[:, 7]
        x[:, 9] = x[:, 7]
        x[:, 30] = x[:, 2]
    return x


@pytest.mark.parametrize("template", ["SPHERE", "SQUARE"])
def test_atlasnet_eval_matches_jax(template):
    kw = dict(number_points=50, nb_primitives=2, template_type=template,
              bottleneck_size=32, hidden_neurons=16)
    jmodel = jax_atlas.AtlasNet(**kw)
    x = clouds(3, 40, seed=1)
    tpl = np.stack([jmodel.regular_template()] * 2)
    params, stats = perturbed(jmodel.init(jax.random.PRNGKey(0), x, tpl), seed=2)
    want, want_latent = jmodel.apply({"params": params, "batch_stats": stats}, x)
    model = atlasnet.AtlasNet(**kw)
    model.load_state_dict(state_dict_from_flax(params, stats))
    with torch.no_grad():
        got, latent = model.eval()(torch.from_numpy(x))
    assert got.shape == (3, 50, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want_latent), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(model.regular_template(), jmodel.regular_template())
    want_code = jmodel.apply({"params": params, "batch_stats": stats}, x,
                             method=jax_atlas.AtlasNet.encode)
    with torch.no_grad():
        code = model.encode(torch.from_numpy(x))
    np.testing.assert_allclose(code.numpy(), np.asarray(want_code), rtol=0, atol=1e-5)


def test_graph_features_match_jax_with_duplicates():
    x = clouds(2, 48, seed=3, dup=True)
    want_idx, want_cov = jax_fold.graph_features(x)
    idx, cov = foldingnet.graph_features(torch.from_numpy(x))
    assert idx.dtype == torch.int32 and idx.shape == (2, 48, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(cov.numpy(), np.asarray(want_cov), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(foldingnet.folding_grid(), jax_fold.folding_grid())


def test_foldingnet_eval_matches_jax():
    jmodel = jax_fold.FoldingNet()
    x = clouds(2, 48, seed=4, dup=True)
    nbr, cov = jax_fold.graph_features(x)
    params, stats = perturbed(jmodel.init(jax.random.PRNGKey(0), x, cov, nbr), seed=5)
    want, want_mid, want_code = jmodel.apply({"params": params, "batch_stats": stats},
                                             x, cov, nbr)
    model = foldingnet.FoldingNet()
    model.load_state_dict(state_dict_from_flax(params, stats))
    pnbr, pcov = foldingnet.graph_features(torch.from_numpy(x))
    with torch.no_grad():
        got, mid, code = model.eval()(torch.from_numpy(x), pcov, pnbr)
    assert got.shape == (2, 2025, 3)
    with torch.no_grad():
        encoded = model.encode(torch.from_numpy(x), pcov, pnbr)
    want_encoded = jmodel.apply({"params": params, "batch_stats": stats}, x, cov, nbr,
                                method=jax_fold.FoldingNet.encode)
    for g, w in ((got, want), (mid, want_mid), (code, want_code),
                 (encoded, want_encoded)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def zero_gradient_params(names, kind):
    """Parameters whose true gradient is zero (see the module docstring)."""
    out = set()
    for name in names:
        layer, _, leaf = name.rpartition(".")
        last = layer.rpartition(".")[2]
        if leaf != "bias":
            continue
        if kind == "atlasnet":
            dense_before_bn = (last.startswith(("conv", "lin")) and last != "last_conv")
            # bn3 feeds the max and lin1's norm; bn5 is the latent, which
            # every decoder adds before its first norm
            if dense_before_bn or layer in ("encoder.bn3", "encoder.bn5"):
                out.add(name)
        else:
            if layer.startswith("encoder.") and (
                    last.startswith("conv") or last == "fc1" or last == "bn5"):
                out.add(name)
    return out


def sync_port(jt, pt, with_adam):
    pt.model.load_state_dict(state_dict_from_flax(np_tree(jt.state.params),
                                                  np_tree(jt.state.batch_stats)))
    if with_adam:
        adam = jt.state.opt_state[0]
        state = adam_state_from_optax(adam.count, np_tree(adam.mu), np_tree(adam.nu))
        pt.optimizer.state.clear()
        for name, p in pt.model.named_parameters():
            pt.optimizer.state[p] = state[name]


def check_three_steps(jt, pt, kind, batches, port_step):
    @jax.jit
    def jax_grads(state, x, key):
        def loss_fn(params):
            recon, _ = jt._apply_train(
                {"params": params, "batch_stats": state.batch_stats}, x, key)
            return jnp.mean(jax_chamfer(recon, x))
        return jax.grad(loss_fn)(state.params)

    skipped = zero_gradient_params(dict(pt.model.named_parameters()), kind)
    assert skipped
    for step, x in enumerate(batches):
        sync_port(jt, pt, with_adam=step > 0)
        key = jax.random.PRNGKey(step)
        grads = state_dict_from_flax(np_tree(jax_grads(jt.state, x, key)),
                                     np_tree(jt.state.batch_stats))
        jt.state, jloss = jt._jit_train_step(jt.state, x, key)
        ploss = port_step(torch.from_numpy(x), key)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                                   err_msg=f"{kind} step {step}")
        want = state_dict_from_flax(np_tree(jt.state.params), np_tree(jt.state.batch_stats))
        got = pt.model.state_dict()
        params = dict(pt.model.named_parameters())
        held = total = 0
        for name, w in want.items():
            g, w = got[name].numpy(), w.numpy()
            if "running_" in name:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4 * np.abs(w).max(),
                                           err_msg=f"{name}, step {step}")
            elif name not in skipped:
                gj, gp = grads[name].numpy(), params[name].grad.numpy()
                agree = np.abs(gp - gj) <= 1e-2 * np.abs(gj)
                np.testing.assert_allclose(g[agree], w[agree], atol=1e-5,
                                           err_msg=f"{name}, step {step}")
                held, total = held + agree.sum(), total + agree.size
        assert held >= 0.9 * total, (kind, step, held / total)


def test_atlasnet_three_train_steps_match_jax():
    """Full width (bottleneck 1024, hidden 512), 64 points in two SPHERE
    primitives, batch 4 of 32-point clouds; the JAX step's random template
    (random_template_points of its key) injected."""
    jt = JaxAtlas(number_points=64, nb_primitives=2, n_points_input=32)
    pt = AtlasNetTrainer(number_points=64, nb_primitives=2, device="cpu")
    model = jt.model

    def port_step(x, key):
        tpl = jax_atlas.random_template_points(key, model.nb_primitives,
                                               model.pts_per_primitive, model.template_dim)
        return pt._train_step(x, template=torch.from_numpy(np.array(tpl)))

    check_three_steps(jt, pt, "atlasnet", [shapes(4, 32, seed=10 + s) for s in range(3)],
                      port_step)


def test_foldingnet_three_train_steps_match_jax():
    jt = JaxFold(n_points_input=48)
    pt = FoldingNetTrainer(device="cpu")
    check_three_steps(jt, pt, "foldingnet",
                      [shapes(4, 48, seed=20 + s) for s in range(3)],
                      lambda x, key: pt._train_step(x))


@pytest.mark.parametrize("kind", ["atlasnet", "foldingnet"])
def test_trainer_inference_matches_jax(kind, tmp_path):
    """From the JAX trainer's init bridged into the port's checkpoint format:
    get_reconstructions and evaluate (FoldingNet's middle loss included)
    match; train then save/restore round-trips."""
    if kind == "atlasnet":
        jt = JaxAtlas(number_points=36, n_points_input=40, template_type="SQUARE")
        pt = AtlasNetTrainer(number_points=36, template_type="SQUARE", device="cpu")
    else:
        jt = JaxFold(n_points_input=40)
        pt = FoldingNetTrainer(device="cpu")
    sync_port(jt, pt, with_adam=False)
    x = clouds(5, 40, seed=6)
    np.testing.assert_allclose(pt.get_reconstructions(x, batch_size=2),
                               jt.get_reconstructions(x, batch_size=2), rtol=0, atol=1e-5)
    want, got = jt.evaluate(x, batch_size=3), pt.evaluate(x, batch_size=3)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5)
    stats = pt.train(x, epochs=2, batch_size=2)
    assert [s[0] for s in stats] == [1, 2] and np.isfinite([s[1] for s in stats]).all()
    pt.save(str(tmp_path))
    other = type(pt)(**({"number_points": 36, "template_type": "SQUARE"}
                        if kind == "atlasnet" else {}), seed=3, device="cpu")
    other.restore(str(tmp_path))
    assert other.epoch == 2
    np.testing.assert_array_equal(other.get_reconstructions(x), pt.get_reconstructions(x))
