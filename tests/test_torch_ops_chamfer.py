"""The port's chamfer ops (geometric_adv_tpu_torch/ops/chamfer.py) against a
float32 numpy brute force and the JAX package, on the CPU.

On the CPU the ops run their plain PyTorch versions, which are what the
CUDA kernels K1-K3 are held to on the card (chip_smoke.py,
tests/test_torch_cuda.py). Bars: distances bit-equal to the brute force
and within 1e-7 of JAX's "direct" path; indices exact, first index on
ties; gradients within 2.6e-6 (DESIGN.md section 6) of the JAX VJP and of
the JAX Pallas backward run in interpreter mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geometric_adv_tpu.ops.chamfer as jchamfer
from geometric_adv_tpu_torch.ops import chamfer as tchamfer
from geometric_adv_tpu_torch.ops.cuda import chamfer as tcuda

GRAD_TOL = 2.6e-6


def tie_clouds(seed, lead, n, m):
    """Seeded float32 clouds with exact ties: duplicated points in both
    clouds and query points that coincide with points of the other."""
    rng = np.random.RandomState(seed)
    x1 = rng.randn(*lead, n, 3).astype(np.float32)
    x2 = rng.randn(*lead, m, 3).astype(np.float32)
    x2[..., 5, :] = x2[..., 17, :]
    x1[..., 9, :] = x1[..., 30, :]
    x1[..., 3, :] = x2[..., 7, :]
    x1[..., 4, :] = x2[..., 5, :]  # nearest to a duplicated pair: idx 5 wins
    return x1, x2


def brute_force(x1, x2):
    """((dx*dx) + (dy*dy)) + (dz*dz) in float32, then min / first argmin."""
    d = x1[..., :, None, :] - x2[..., None, :, :]
    sq = d * d
    sqd = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    return (sqd.min(-1), sqd.argmin(-1).astype(np.int32),
            sqd.min(-2), sqd.argmin(-2).astype(np.int32))


SHAPES = [((4,), 64, 64), ((3,), 37, 91), ((2,), 130, 48), ((2, 3), 40, 33)]


@pytest.mark.parametrize("lead,n,m", SHAPES)
def test_nn_distance_matches_brute_force_and_jax(lead, n, m):
    x1, x2 = tie_clouds(n * 1000 + m, lead, n, m)
    got = [t.numpy() for t in
           tchamfer.nn_distance(torch.from_numpy(x1), torch.from_numpy(x2))]
    want = brute_force(x1, x2)
    jax_out = [np.asarray(t) for t in jchamfer.nn_distance(x1, x2, "direct")]
    for g, w, j in zip(got, want, jax_out):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, j)
        else:
            np.testing.assert_allclose(g, j, rtol=0, atol=1e-7)
    assert got[1][..., 4].tolist() == np.full(lead, 5).tolist()


@pytest.mark.parametrize("lead,n,m", SHAPES)
def test_nn_distance_values_matches_full_op_and_jax(lead, n, m):
    x1, x2 = tie_clouds(n * 7 + m, lead, n, m)
    v1, v2 = tchamfer.nn_distance_values(torch.from_numpy(x1),
                                         torch.from_numpy(x2))
    d1, _, d2, _ = brute_force(x1, x2)
    np.testing.assert_array_equal(v1.numpy(), d1)
    np.testing.assert_array_equal(v2.numpy(), d2)
    j1, j2 = jchamfer.nn_distance_values(x1, x2, "direct")
    np.testing.assert_allclose(v1.numpy(), np.asarray(j1), rtol=0, atol=1e-7)
    np.testing.assert_allclose(v2.numpy(), np.asarray(j2), rtol=0, atol=1e-7)


def test_chamfer_loss_per_pc_matches_jax():
    x1, x2 = tie_clouds(3, (5,), 40, 52)
    got = tchamfer.chamfer_loss_per_pc(torch.from_numpy(x1), torch.from_numpy(x2))
    want = jchamfer.chamfer_loss_per_pc(x1, x2, method="composed")
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8)
    total = tchamfer.chamfer_loss(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(total.item(), got.mean().item(), rtol=1e-6)


@pytest.mark.parametrize("n,m", [(70, 50), (33, 33)])
def test_grad_matches_jax_vjp_and_pallas_backward(n, m):
    from jax.experimental.pallas import tpu as pltpu

    from geometric_adv_tpu.ops.pallas.chamfer_bwd_kernel import (
        chamfer_grad1_pallas,
    )

    x1, x2 = tie_clouds(n + m, (2,), n, m)
    rng = np.random.RandomState(n)
    g1 = rng.rand(2, n).astype(np.float32)
    g2 = rng.rand(2, m).astype(np.float32)

    t1 = torch.from_numpy(x1).requires_grad_(True)
    t2 = torch.from_numpy(x2).requires_grad_(True)
    d1, _, d2, _ = tchamfer.nn_distance(t1, t2)
    ((d1 * torch.from_numpy(g1)).sum() + (d2 * torch.from_numpy(g2)).sum()
     ).backward()

    def f(a, b):
        e1, _, e2, _ = jchamfer.nn_distance(a, b, "direct")
        return jnp.sum(e1 * g1) + jnp.sum(e2 * g2)

    j1, j2 = jax.grad(f, argnums=(0, 1))(x1, x2)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(j1), atol=GRAD_TOL)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(j2), atol=GRAD_TOL)

    _, i1, _, i2 = brute_force(x1, x2)
    with pltpu.force_tpu_interpret_mode():
        p1 = np.asarray(chamfer_grad1_pallas(x1, x2, i1, i2, g1, g2))
        p2 = np.asarray(chamfer_grad1_pallas(x2, x1, i2, i1, g2, g1))
    np.testing.assert_allclose(t1.grad.numpy(), p1, atol=GRAD_TOL)
    np.testing.assert_allclose(t2.grad.numpy(), p2, atol=GRAD_TOL)


def test_backward_computes_only_requested_directions(monkeypatch):
    """grad2 is skipped when xyz2 needs no gradient (the attack's case)."""
    calls = []
    plain = tchamfer.chamfer_grad1_plain

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(tchamfer, "chamfer_grad1_plain", counting)
    x1, x2 = tie_clouds(0, (2,), 40, 30)
    t1 = torch.from_numpy(x1).requires_grad_(True)
    loss = tchamfer.chamfer_loss_per_pc(t1, torch.from_numpy(x2)).sum()
    loss.backward()
    assert calls == [(2, 40, 3)]
    assert t1.grad.shape == (2, 40, 3)


def test_cpu_tensors_never_reach_the_kernels():
    """A CPU tensor takes the plain version and launches nothing; the
    kernel wrappers refuse it; a tensor on another device raises."""
    x1, x2 = tie_clouds(1, (2,), 36, 24)
    a, b = torch.from_numpy(x1), torch.from_numpy(x2)
    tcuda.reset_launch_counts()
    tchamfer.nn_distance(a, b)
    tchamfer.nn_distance_values(a, b)
    assert set(tcuda.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        tcuda.nn_distance_cuda(a, b)
    with pytest.raises(ValueError):
        tcuda.nn_distance_values_cuda(a, b)
    with pytest.raises(ValueError):
        tchamfer.nn_distance(a.to("meta"), b.to("meta"))


def test_fscore_matches_jax():
    rng = np.random.RandomState(0)
    d1 = (rng.rand(3, 50) * 0.002).astype(np.float32)
    d2 = (rng.rand(3, 40) * 0.002).astype(np.float32)
    d2[1] = 1.0  # precision 0 on one side
    got = tchamfer.fscore(torch.from_numpy(d1), torch.from_numpy(d2))
    want = jchamfer.fscore(d1, d2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
