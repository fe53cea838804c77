"""The exact skips of the EMD sweep kernel K7 (csrc/emd_sweep.cu), pinned on
the CPU through the plain sweep.

K7 skips a (warp, element) pair of a sweep when every lane's kernel value
exp(level * d2) is exactly +0, that is when level * d2 is below
``EXP_UNDERFLOW``, and sets K = 1 without exp at level 0. Here: float32
exp is +0 exactly below that threshold and positive from it on; every level
is -4^j or 0, so level * d2 in float32 is the exact product; and the plain
sweep with K forced to those values keeps every bit of the plain sweep, in
all four gradient modes, on the synthetic dataset's clouds. The card holds
K7 against the plain sweep (tests/test_torch_cuda.py, chip_smoke.py) and
scans its own expf over the same range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.ops import emd as jemd
from geometric_adv_tpu_torch.data.synthetic import sample_shape
from geometric_adv_tpu_torch.ops import emd
from geometric_adv_tpu_torch.ops.cuda.emd import EXP_UNDERFLOW

MODES = [(True, True), (True, False), (False, True), (False, False)]


def floats_between(lo: float, hi: float) -> torch.Tensor:
    """Every float32 in [lo, hi] for lo < hi < 0, by its bits."""
    a = int(np.float32(hi).view(np.int32))
    b = int(np.float32(lo).view(np.int32))
    return torch.arange(a, b + 1, dtype=torch.int32).view(torch.float32)


def test_exp_is_zero_exactly_below_the_underflow_threshold():
    t = floats_between(-110.0, -100.0)
    assert len(t) > 10**6
    e = torch.exp(t)
    zero = e.view(torch.int32) == 0  # +0, not -0
    assert torch.equal(zero, t < EXP_UNDERFLOW)
    assert (e[~zero] > 0).all()
    assert np.float32(EXP_UNDERFLOW) == EXP_UNDERFLOW  # a float32 value


def test_levels_times_a_float32_distance_are_exact():
    rng = np.random.RandomState(0)
    sqd = np.concatenate([rng.rand(10**5) * 3, rng.rand(10**5) * 1e-3,
                          np.exp(rng.uniform(-80, 40, 10**5))]).astype(np.float32)
    for level in emd._LEVELS:
        assert level == 0.0 or 2.0 ** round(np.log2(-level)) == -level
        got = (np.float32(level) * sqd).astype(np.float64)
        np.testing.assert_array_equal(got, np.float64(level) * sqd.astype(np.float64))


def skipping_kernel(level, sqd):
    """exp(level * d2) as K7 evaluates it: +0 where the product is below
    the threshold (and finite), 1 at level 0 where d2 is finite."""
    t = level * sqd
    k = torch.exp(t)
    k = torch.where((t < EXP_UNDERFLOW) & (t > -torch.inf), torch.zeros_like(k), k)
    if level == 0.0:
        k = torch.where(sqd <= torch.finfo(sqd.dtype).max, torch.ones_like(k), k)
    return k


def surface_clouds(b, n, m, seed):
    rng = np.random.RandomState(seed)
    classes = ("sphere", "cube", "torus", "cone")
    x = np.stack([sample_shape(classes[i % 4], n, rng) for i in range(b)])
    y = np.stack([sample_shape(classes[(i + 1) % 4], m, rng) for i in range(b)])
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("n,m", [(256, 256), (1024, 512), (300, 1024)])
def test_plain_sweep_with_the_skips_keeps_every_bit(monkeypatch, n, m):
    x, y = surface_clouds(2, n, m, seed=n + m)
    want = {mode: emd.emd_sweep_plain(x, y, *mode) for mode in MODES}
    zeros = []

    def counting(level, sqd):
        k = skipping_kernel(level, sqd)
        zeros.append(float((k == 0).double().mean()))
        return k

    monkeypatch.setattr(emd, "auction_kernel", counting)
    for mode in MODES:
        got = emd.emd_sweep_plain(x, y, *mode)
        for g, w in zip(got, want[mode]):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)
    # the two highest levels set most of their planes to exact zeros
    assert zeros[0] > 0.5 and zeros[1] > 0.1


def test_plain_sweep_with_the_skips_matches_jax(monkeypatch):
    """The skipping sweep against the JAX package's sweep in float64, where
    the comparison sees the algorithm and not the rounding, at the bars of
    tests/test_torch_ops_emd.py (on these surface clouds the two frameworks'
    float32 sweeps differ by 1.1e-4 * max|g| with or without the skips:
    the JAX sweep's x * s0 - s1 gradient cancels)."""
    x, y = (t.double() for t in surface_clouds(2, 256, 192, seed=3))
    c_ref, g1_ref, g2_ref = (np.asarray(a) for a in jemd._emd_fused_impl(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), want_grads=True))
    monkeypatch.setattr(emd, "auction_kernel", skipping_kernel)
    cost, g1, g2 = emd.emd_sweep_plain(x, y)
    np.testing.assert_allclose(cost.numpy(), c_ref, rtol=1e-5)
    scale = float(np.max(np.abs(g1_ref)))
    np.testing.assert_allclose(g1.numpy(), g1_ref, atol=1e-5 * scale)
    np.testing.assert_allclose(g2.numpy(), g2_ref, atol=1e-5 * scale)
