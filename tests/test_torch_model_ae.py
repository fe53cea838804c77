"""The port's victim AE (geometric_adv_tpu_torch/models) against the JAX
package's, with the JAX weights bridged into the port (models/bridge.py).

Tolerance: 1e-5 absolute and relative in float32 — the two frameworks'
CPU matmuls sum in different orders; everything else is elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.models import PointNetAE as JaxAE
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE, init_weights

TOL = dict(rtol=1e-5, atol=1e-5)


def jax_variables(model, n, seed=0, perturb_bn=True):
    """flax init, with BN scale/bias/statistics made non-trivial so the
    bridge's mapping of every leaf is exercised."""
    variables = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, n, 3), jnp.float32), train=False
    )
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    if perturb_bn:
        rng = np.random.RandomState(seed)
        for name, leaves in params["encoder"].items():
            if name.startswith("bn_"):
                c = leaves["scale"].shape[0]
                leaves["scale"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
                leaves["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
                stats["encoder"][name]["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
                stats["encoder"][name]["var"] = (0.5 + rng.rand(c)).astype(np.float32)
    return params, stats


def bridged(port_model, params, stats):
    port_model.load_state_dict(state_dict_from_flax(params, stats))
    return port_model.eval()


def test_param_count_full_width():
    model = PointNetAE(n_points=2048, bneck_size=128)
    assert sum(p.numel() for p in model.parameters()) == 1_770_240


@pytest.mark.parametrize(
    "n,bneck,enc,dec",
    [(64, 16, None, None), (32, 8, [16, 8], [16, 16]), (2048, 128, None, None)],
    ids=["small", "tiny", "full_width"],
)
def test_forward_matches_jax_with_bridged_weights(n, bneck, enc, dec):
    jmodel = JaxAE(n_points=n, bneck_size=bneck, encoder_filters=enc,
                   decoder_sizes=dec)
    params, stats = jax_variables(jmodel, n)
    x = np.random.RandomState(n).randn(2, n, 3).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats}, x, train=False)

    model = bridged(PointNetAE(n_points=n, bneck_size=bneck, encoder_filters=enc,
                               decoder_sizes=dec), params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        z = model.encode(torch.from_numpy(x))
        recon = model.decode(z)
    for g, w in zip(got, want):  # recon, z, pre_symmetry
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(z.numpy(), got[1].numpy())
    np.testing.assert_array_equal(recon.numpy(), got[0].numpy())


def test_close_with_tanh_matches_jax():
    jmodel = JaxAE(n_points=32, bneck_size=8, close_with_tanh=True)
    params, stats = jax_variables(jmodel, 32, seed=1)
    x = np.random.RandomState(1).randn(3, 32, 3).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats}, x, train=False)
    model = bridged(PointNetAE(n_points=32, bneck_size=8, close_with_tanh=True),
                    params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), **TOL)


def test_input_gradient_matches_jax():
    """The attack differentiates the frozen AE wrt its input."""
    jmodel = JaxAE(n_points=32, bneck_size=8, encoder_filters=[16, 8],
                   decoder_sizes=[16, 16])
    params, stats = jax_variables(jmodel, 32, seed=2)
    x = np.random.RandomState(2).randn(2, 32, 3).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want = jax.grad(
        lambda a: jnp.sum(jmodel.apply(variables, a, train=False)[0] ** 2)
    )(x)
    model = bridged(PointNetAE(n_points=32, bneck_size=8, encoder_filters=[16, 8],
                               decoder_sizes=[16, 16]), params, stats)
    xt = torch.from_numpy(x).requires_grad_(True)
    (model(xt)[0] ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_seeded_init_is_deterministic_and_eval_only():
    """Seeded init; train mode normalises with the batch statistics and
    moves the running ones by (1 - momentum), eval mode leaves them."""
    a = init_weights(PointNetAE(64, 16), torch.Generator().manual_seed(3))
    b = init_weights(PointNetAE(64, 16), torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.encoder.conv_1.weight  # fan_in 64: truncated at 2 / sqrt(64) / .88
    assert w.abs().max() <= 2 * (1 / 8) / 0.87962566103423978 + 1e-6
    assert w.std().item() == pytest.approx(1 / 8, rel=0.1)
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 64, 3).astype(np.float32))
    bn = a.encoder.bn_0
    before = bn.running_mean.clone(), bn.running_var.clone()
    with torch.no_grad():
        a.eval()(x)
    assert torch.equal(bn.running_mean, before[0])
    with torch.no_grad():
        pre = a.encoder.conv_0(x)
        a.train()(x)
    mean = pre.mean(dim=(0, 1))
    var = (pre * pre).mean(dim=(0, 1)) - mean * mean
    assert torch.allclose(bn.running_mean, 0.9 * before[0] + 0.1 * mean, atol=1e-6)
    assert torch.allclose(bn.running_var, 0.9 * before[1] + 0.1 * var, atol=1e-6)
