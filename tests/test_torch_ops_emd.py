"""The port's EMD op (geometric_adv_tpu_torch/ops/emd.py) against the JAX
package's (geometric_adv_tpu/ops/emd.py), on the CPU.

Bars: those of tests/test_ops_emd.py:187-192 -- cost rtol 1e-5, gradients
atol 1e-5 * max|g| -- in float64, where the comparison sees the algorithm
and not the rounding. In float32 the auction amplifies rounding: XLA fuses
the distance plane with FMAs where the port rounds each operation, and the
sweep's ``x * s0 - s1`` gradient form cancels, so the two frameworks' f32
sweeps differ by up to 3.2e-5 * max|g| on random draws (measured over 8
seeds at these shapes) while their costs agree within 1.5e-6. The float32
case therefore holds the gradients at 1e-4 * max|g|, the on-device bar of
geometric_adv_tpu/cli/verify_tpu.py:482.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.ops import emd as jemd
from geometric_adv_tpu_torch.ops import emd
from geometric_adv_tpu_torch.ops.cuda import emd as cuda_emd

SHAPES = [(40, 24), (24, 40), (32, 32), (64, 32)]
GRAD_BAR = {np.float64: 1e-5, np.float32: 1e-4}


def clouds(n, m, dtype=np.float32, b=2, seed=0):
    rng = np.random.RandomState(seed + 97 * n + m)
    return (rng.rand(b, n, 3).astype(dtype) - 0.5,
            rng.rand(b, m, 3).astype(dtype) - 0.5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,m", SHAPES)
def test_sweep_plain_matches_jax(n, m, dtype):
    x, y = clouds(n, m, dtype)
    c_ref, g1_ref, g2_ref = (np.asarray(a) for a in jemd._emd_fused_impl(
        jnp.asarray(x), jnp.asarray(y), want_grads=True))
    cost, g1, g2 = emd.emd_sweep_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert cost.dtype == torch.from_numpy(x).dtype and g1.shape == (2, n, 3)
    np.testing.assert_allclose(cost.numpy(), c_ref, rtol=1e-5)
    scale = float(np.max(np.abs(g1_ref))) + 1e-9
    np.testing.assert_allclose(g1.numpy(), g1_ref, atol=GRAD_BAR[dtype] * scale)
    np.testing.assert_allclose(g2.numpy(), g2_ref, atol=GRAD_BAR[dtype] * scale)


@pytest.mark.parametrize("n,m", [(64, 64), (128, 32), (32, 128)])
def test_approx_match_matches_jax(n, m):
    """The bars of tests/test_ops_emd.py:52-59."""
    x, y = clouds(n, m)
    want = np.asarray(jemd.approx_match(x, y))
    got = emd.approx_match(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, m, n) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_match_cost_value_and_gradient_match_jax():
    """float64; the JAX backward forms its two contractions in float32
    (``preferred_element_type``) and subtracts them, hence gradients within
    1e-6 * max|g|."""
    x, y = clouds(24, 16, np.float64, b=2)
    match = np.array(jemd.approx_match(x, y))
    want = np.asarray(jemd.match_cost(x, y, match))
    wg1, wg2 = jax.grad(lambda a, c: jnp.sum(jemd.match_cost(a, c, match) ** 2),
                        argnums=(0, 1))(x, y)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    cost = emd.match_cost(tx, ty, torch.from_numpy(match))
    (cost ** 2).sum().backward()
    np.testing.assert_allclose(cost.detach().numpy(), want, rtol=1e-10)
    scale = float(np.max(np.abs(np.asarray(wg1))))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wg1), atol=1e-6 * scale)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(wg2), atol=1e-6 * scale)


@pytest.mark.parametrize("n,m", [(48, 48), (64, 32)])
def test_emd_loss_fused_gradients_match_jax_grad(n, m):
    """d/dpred and d/dgt of sum(w * cost), each alone and both at once."""
    x, y = clouds(n, m, np.float64)
    w = np.linspace(0.5, 1.5, 2)
    f = lambda a, c: jnp.sum(w * jemd.emd_loss_fused(a, c))  # noqa: E731
    j1, j2 = jax.grad(f, argnums=(0, 1))(x, y)
    scale = float(np.max(np.abs(np.asarray(j1))))
    for wrt in ((0,), (1,), (0, 1)):
        args = [torch.from_numpy(a).requires_grad_(i in wrt)
                for i, a in enumerate((x, y))]
        cost = emd.emd_loss_fused(*args)
        np.testing.assert_allclose(cost.detach().numpy(),
                                   np.asarray(jemd.emd_loss_fused(x, y)), rtol=1e-5)
        (torch.from_numpy(w) * cost).sum().backward()
        for i, want in ((0, j1), (1, j2)):
            got = args[i].grad
            assert (got is not None) == (i in wrt)
            if got is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-5 * scale)


def test_emd_loss_fused_asks_only_for_the_wanted_gradients(monkeypatch):
    """The sweep computes g2 only when gt needs a gradient (the attack and
    AE training differentiate wrt the first argument alone), and runs
    value-only under no_grad."""
    calls = []
    plain = emd.emd_sweep_plain

    def spy(x, y, want_g1=True, want_g2=True):
        calls.append((want_g1, want_g2))
        return plain(x, y, want_g1, want_g2)

    monkeypatch.setattr(emd, "emd_sweep_plain", spy)
    x, y = (torch.from_numpy(a) for a in clouds(20, 30))
    emd.emd_loss_fused(x.clone().requires_grad_(True), y).sum().backward()
    emd.emd_loss_fused(x, y.clone().requires_grad_(True)).sum().backward()
    with torch.no_grad():
        emd.emd_loss_fused(x.clone().requires_grad_(True), y)
    emd.emd_loss_per_pc(x, y)
    assert calls == [(True, False), (False, True), (False, False), (False, False)]


def test_value_only_cost_is_bit_equal_to_grads_mode():
    for n, m in SHAPES:
        x, y = (torch.from_numpy(a) for a in clouds(n, m))
        ref = emd.emd_sweep_plain(x, y, True, True)[0]
        for flags in ((False, False), (True, False), (False, True)):
            assert torch.equal(emd.emd_sweep_plain(x, y, *flags)[0], ref)
        assert torch.equal(emd.emd_loss_fused(x.clone().requires_grad_(True), y)
                           .detach(), ref)


def test_emd_loss_fused_keeps_leading_dims():
    x, y = (torch.from_numpy(a) for a in clouds(16, 12, b=6))
    got = emd.emd_loss_fused(x.reshape(2, 3, 16, 3), y.reshape(2, 3, 12, 3))
    assert got.shape == (2, 3)
    assert torch.equal(got.reshape(6), emd.emd_loss_fused(x, y))


@pytest.mark.parametrize("n,m,route", [
    (1024, 1024, "block"), (1025, 1024, "tiled"), (1024, 1025, "tiled"),
    (2048, 2048, "tiled"), (1024, 512, "block"), (500, 1000, "block"),
    (100, 20, "block"), (2048, 500, "tiled"),
])
def test_cuda_route_is_the_tpu_kernel_gate(n, m, route):
    from geometric_adv_tpu.ops.pallas.emd_fused_kernel import fused_sweep_supported

    assert emd.sweep_route(n, m) == route
    assert (route == "block") == fused_sweep_supported(n, m)


def test_levels_and_multipliers_match_jax():
    assert emd._LEVELS == jemd._LEVELS and len(emd._LEVELS) == 10
    for n, m in [(2048, 2048), (1024, 512), (500, 1000), (7, 3), (3, 7)]:
        mult_l, mult_r = cuda_emd.multipliers(n, m)
        assert (mult_l, mult_r) == ((1.0, float(n // m)) if n >= m
                                    else (float(m // n), 1.0))


def test_wrappers_refuse_cpu_tensors():
    x, y = (torch.from_numpy(a) for a in clouds(16, 16))
    for fn in (cuda_emd.emd_sweep_block_cuda, cuda_emd.emd_sweep_tiled_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, y, emd._LEVELS, True, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        emd.emd_loss_fused(x.to("meta"), y.to("meta"))


def test_emd_gradient_at_a_tiny_displacement():
    """At the attack's start adv = x + pert with |pert| ~ 1e-7: each point
    keeps nearly all its mass on its own source, so d EMD(adv, x) / d adv is
    close to each point's unit displacement (adv - x) / |adv - x| (within
    2e-3: a little mass reaches close neighbours). The JAX package's CPU
    sweep forms this gradient as
    x * s0 - s1 from float32 terms near 3e6, which cancel; the port's float64
    sums keep its float32 run within 1e-5 of its float64 run."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32))
    adv = (x + torch.from_numpy((rng.randn(2, 64, 3) * 1e-7).astype(np.float32)))
    adv.requires_grad_(True)
    cost = emd.emd_loss_fused(adv, x)
    cost.sum().backward()
    exact = emd.emd_sweep_plain(adv.detach().double(), x.double(), True, False)
    np.testing.assert_allclose(adv.grad.numpy(), exact[1].numpy(), atol=1e-5)
    np.testing.assert_allclose(cost.detach().numpy(), exact[0].numpy(), rtol=1e-4)
    disp = (adv.detach() - x).double()
    norm = disp.norm(dim=-1, keepdim=True)
    assert (norm > 0).all()
    np.testing.assert_allclose(adv.grad.numpy(), (disp / norm).numpy(), atol=2e-3)
