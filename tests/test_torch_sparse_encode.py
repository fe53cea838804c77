"""The port's sparse encoder VJP (geometric_adv_tpu_torch/models/
sparse_encode.py) against the JAX package's ``make_sparse_encode`` and
against dense autograd, mirroring tests/test_sparse_encode.py on its victim
(64 points, encoder [16, 32, 16], BN statistics moved off their init),
bridged into the port.

Bars (tests/test_sparse_encode.py): the forward bit-equal; the input
gradient rtol 2e-5 / atol 1e-7; the attack trajectory metrics rtol 2e-4 /
atol 1e-6 and clouds rtol 1e-4 / atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geometric_adv_tpu.models.sparse_encode as jse
from geometric_adv_tpu.models import PointNetAE as JaxAE
from geometric_adv_tpu_torch.attack import core
from geometric_adv_tpu_torch.models import sparse_encode as se
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE

GRAD = dict(rtol=2e-5, atol=1e-7)


def build(n=64, bneck=16, filters=None, dtype="float32", seed=3):
    """tests/test_sparse_encode.py's victim in both frameworks."""
    filters = filters or [16, 32, bneck]
    jmodel = JaxAE(n_points=n, bneck_size=bneck, encoder_filters=filters,
                   decoder_sizes=[16, 16], dtype=getattr(jnp, dtype))
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)),
                            train=False)
    stats = jax.tree.map(lambda a: a + 0.3 * jnp.abs(a) + 0.01,
                         variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    model = PointNetAE(n_points=n, bneck_size=bneck, encoder_filters=filters,
                       decoder_sizes=[16, 16], dtype=dtype)
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))
    return jmodel, variables, model.eval().requires_grad_(False)


def scalarized_grad(encode, x):
    """Input gradient of sum(sin(z) * [1..bneck]): every channel its own
    cotangent."""
    xr = torch.from_numpy(x).requires_grad_(True)
    z = encode(xr).float()
    (torch.sin(z) * torch.arange(1.0, 1.0 + z.shape[-1])).sum().backward()
    return xr.grad.numpy()


def jax_scalarized_grad(encode, x):
    def f(a):
        z = encode(a).astype(jnp.float32)
        return jnp.sum(jnp.sin(z) * jnp.arange(1.0, 1.0 + z.shape[-1]))

    return np.asarray(jax.grad(f)(jnp.asarray(x)))


def test_forward_bit_identical():
    jmodel, variables, model = build()
    x = np.random.RandomState(0).randn(4, 64, 3).astype(np.float32)
    z = se.make_sparse_encode(model)(torch.from_numpy(x))
    assert torch.equal(z, model.encode(torch.from_numpy(x)))
    # and JAX's sparse forward within the bridged AE's bar
    # (tests/test_torch_model_ae.py: 1e-5; oneDNN and XLA sum apart)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jse.make_sparse_encode(jmodel, variables)(jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scatter_impl", ["onehot", "scatter"])
def test_input_gradient_matches_jax_and_dense(scatter_impl, monkeypatch):
    monkeypatch.setattr(se, "SCATTER_IMPL", scatter_impl)
    monkeypatch.setattr(jse, "SCATTER_IMPL", scatter_impl)
    jmodel, variables, model = build()
    x = np.random.RandomState(1).randn(5, 64, 3).astype(np.float32)
    calls = se.BACKWARD_CALLS
    got = scalarized_grad(se.make_sparse_encode(model), x)
    assert se.BACKWARD_CALLS == calls + 1
    np.testing.assert_allclose(
        got, jax_scalarized_grad(jse.make_sparse_encode(jmodel, variables), x), **GRAD)
    np.testing.assert_allclose(got, scalarized_grad(model.encode, x), **GRAD)


def test_gradient_with_batched_leading_axes():
    """[3, 2, n, 3] inputs (the JAX test's vmap): the sparse backward over
    every leading axis against dense autograd."""
    _, _, model = build()
    x = np.random.RandomState(2).randn(3, 2, 64, 3).astype(np.float32)
    sparse = se.make_sparse_encode(model)
    grads = []
    for encode in (sparse, model.encode):
        xr = torch.from_numpy(x).requires_grad_(True)
        (encode(xr) ** 2).sum().backward()
        grads.append(xr.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], **GRAD)


def test_bf16_model_dtype_runs():
    """A bfloat16 victim: z in bfloat16, the input gradient float32 and
    finite, and z equal to the JAX bfloat16 victim's sparse forward."""
    jmodel, variables, model = build(dtype="bfloat16")
    x = np.random.RandomState(4).randn(2, 64, 3).astype(np.float32)
    xr = torch.from_numpy(x).requires_grad_(True)
    z = se.make_sparse_encode(model)(xr)
    assert z.dtype == torch.bfloat16
    z.float().sum().backward()
    assert xr.grad.dtype == torch.float32 and torch.isfinite(xr.grad).all()
    want = jse.make_sparse_encode(jmodel, variables)(jnp.asarray(x))
    np.testing.assert_array_equal(z.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_dead_channel_zero_gradient_both_paths():
    """An all-rows-dead ReLU channel: dense autograd splits the max tie over
    every row but the mask kills it; sparse kills it at the first row. Both
    exactly zero, as JAX's."""
    jmodel, variables, model = build(n=16, bneck=4, filters=[8, 4])
    with torch.no_grad():
        model.encoder.bn_1.bias -= 1e3
    variables["params"]["encoder"]["bn_1"]["bias"] = (
        variables["params"]["encoder"]["bn_1"]["bias"] - 1e3)
    x = np.random.RandomState(5).randn(2, 16, 3).astype(np.float32)
    assert float(model.encode(torch.from_numpy(x)).abs().max()) == 0.0
    for encode in (se.make_sparse_encode(model), model.encode):
        xr = torch.from_numpy(x).requires_grad_(True)
        encode(xr).sum().backward()
        np.testing.assert_array_equal(xr.grad.numpy(), 0.0)
    g = jax.grad(lambda a: jnp.sum(jse.make_sparse_encode(jmodel, variables)(a)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_ties_follow_the_first_argmax_row():
    """Exact ties at distinct points: a copy of an argmax row placed before
    it takes that row's channels, so the sparse gradient lands on the copy
    alone, as JAX's sparse path; dense autograd splits it evenly."""
    jmodel, variables, model = build()
    x = np.random.RandomState(6).randn(1, 64, 3).astype(np.float32)
    with torch.no_grad():
        idx = model.encoder(torch.from_numpy(x)).argmax(dim=-2)[0]
    r = int(idx.max())  # an argmax row with rows before it
    x[:, 2] = x[:, r]
    got = scalarized_grad(se.make_sparse_encode(model), x)
    want = jax_scalarized_grad(jse.make_sparse_encode(jmodel, variables), x)
    np.testing.assert_allclose(got, want, **GRAD)
    assert np.abs(got[0, 2]).sum() > 0 and np.abs(got[0, r]).sum() == 0
    dense = scalarized_grad(model.encode, x)
    np.testing.assert_allclose(dense[0, 2], dense[0, r], **GRAD)


def test_attack_trajectory_matches_jax_sparse():
    """25 iterations of the attack through the port's sparse VJP against the
    JAX attack through JAX's sparse VJP and against the port's dense one,
    with JAX's init_pert injected."""
    from geometric_adv_tpu.attack.core import attack_batch as jax_attack_batch
    from geometric_adv_tpu.attack.core import init_pert as jax_init_pert

    jmodel, variables, model = build()
    rng = np.random.RandomState(7)
    x = (rng.rand(4, 64, 3) - 0.5).astype(np.float32)
    gt = (rng.rand(4, 64, 3) - 0.5).astype(np.float32)
    ref = np.ones(4, np.float32)
    jsparse = jse.make_sparse_encode(jmodel, variables)
    jdecode = lambda z: jmodel.apply(variables, z, train=False,  # noqa: E731
                                     method=JaxAE.decode)
    tz = np.array(jsparse(jnp.asarray(gt)))
    kw = dict(num_iterations=25, num_iterations_thresh=1, learning_rate=0.01)
    want = jax_attack_batch(lambda a: jsparse(a).astype(jnp.float32), jdecode,
                            jnp.asarray(x), jnp.asarray(tz), jnp.asarray(gt),
                            jnp.asarray(ref), jnp.asarray([1.0]), **kw)
    pert0 = torch.from_numpy(np.array(jax_init_pert((4, 64, 3))))
    t = torch.from_numpy
    outs = {}
    for name, encode in (("sparse", se.make_sparse_encode(model)),
                         ("dense", model.encode)):
        outs[name] = core.attack_batch(encode, model.decode, t(x), t(tz), t(gt), t(ref),
                                       [1.0], pert0=pert0, **kw)
    for got in (outs["sparse"], outs["dense"]):
        np.testing.assert_allclose(got.metrics, np.asarray(want.metrics),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(got.pc_input, np.asarray(want.pc_input),
                                   rtol=1e-4, atol=2e-6)


def test_attack_runner_takes_the_sparse_path_when_asked(monkeypatch):
    """AttackRunner builds the sparse encode when ``encoder_vjp`` is
    "sparse", and not otherwise: "auto" is dense."""
    from geometric_adv_tpu_torch.train.config import Configuration

    calls = []
    real = se.make_sparse_encode

    def spy(model):
        calls.append(1)
        return real(model)

    monkeypatch.setattr(se, "make_sparse_encode", spy)
    conf = Configuration(n_input=[32, 3], bneck_size=8, encoder_filters=[16, 8],
                         decoder_sizes=[16, 16], dist_weight_list=[1.0],
                         num_iterations=3, num_iterations_thresh=1, saver_step=None)
    model = PointNetAE(n_points=32, bneck_size=8, encoder_filters=[16, 8],
                       decoder_sizes=[16, 16])
    runner = core.AttackRunner(model, conf, "cpu", encoder_vjp="sparse")
    assert calls and runner.encoder_vjp == "sparse"
    rng = np.random.RandomState(0)
    src, tgt = (rng.rand(2, 32, 3).astype(np.float32) for _ in range(2))
    before = se.BACKWARD_CALLS
    out = runner.attack(src, runner.encode(torch.from_numpy(tgt)).detach().numpy(), tgt,
                        np.ones(2, np.float32))
    assert se.BACKWARD_CALLS == before + 3 and np.isfinite(out.metrics).all()
    calls.clear()
    assert core.AttackRunner(model, conf, "cpu").encoder_vjp == "dense" and not calls
    assert core.AttackRunner(model, conf, "cpu", encoder_vjp="dense").encoder_vjp == "dense"
    assert not calls
    with pytest.raises(ValueError):
        core.AttackRunner(model, conf, "cpu", encoder_vjp="fast")
