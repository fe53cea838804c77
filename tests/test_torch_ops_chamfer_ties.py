"""Exact ties that straddle the chamfer forward kernels' block, cluster,
step and chunk boundaries, through the port's plain versions and the JAX
package on the CPU.

The redesigned K1/K2 (csrc/nn_distance.cu) split a cloud's rows into
tiles spread over a cluster of blocks (K1 256 rows, 4 row groups of 8 per
warp; K2 64) and its columns into steps (K1 32 points, K2 128) and
2048-point chunks; K5's payload pass sums each snn1 segment in ascending j.
On the card (tests/test_torch_cuda.py, chip_smoke.py) the kernels are held
bit-equal to the plain versions on these clouds; here the plain versions
are held to the JAX package: indices equal and distances bit-equal to its
"direct" method, the payloads at tests/test_torch_ops_chamfer_fused.py's
bars against the JAX kernel in interpreter mode, and snn1 and the
gradients of K3 and K4 (csrc/chamfer_grad.cu, which adds each point's
scatter terms in ascending j, in each algebra) bit-equal to explicit
ascending-j loops.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import geometric_adv_tpu.ops.chamfer as jchamfer
from geometric_adv_tpu_torch.ops import chamfer as tchamfer


def straddling_ties(b, n, m, seed):
    """Uniform clouds whose exact ties straddle the kernels' boundaries:
    rows 3 and 1500 (other tiles, other blocks) both equal column 7, whose
    argmin must be 3; columns 5 and 1800 (other steps) both equal row 40,
    whose argmin must be 5; rows 255 and 256 (a 64-row tile boundary) equal
    column 300; columns 255 and 256 (a 128-point step boundary) equal row
    600; past 2048 points, row 2100 also equals column 7."""
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x1[:, 3] = x1[:, 1500] = x2[:, 7]
    x2[:, 1800] = x2[:, 5]
    x1[:, 40] = x2[:, 5]
    x1[:, 255] = x1[:, 256] = x2[:, 300]
    x2[:, 256] = x2[:, 255]
    x1[:, 600] = x2[:, 255]
    if n > 2100:
        x1[:, 2100] = x2[:, 7]
    return x1, x2


@pytest.mark.parametrize("n,m", [(2048, 2048), (2500, 2048)])
def test_plain_versions_match_jax_on_straddling_ties(n, m):
    x1, x2 = straddling_ties(2, n, m, seed=n)
    got = [t.numpy() for t in tchamfer.nn_distance(torch.from_numpy(x1),
                                                   torch.from_numpy(x2))]
    want = [np.asarray(a) for a in jchamfer.nn_distance(x1, x2, "direct")]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    d1, i1, d2, i2 = got
    assert (i2[:, 7] == 3).all() and (i1[:, 40] == 5).all()
    assert (i2[:, 300] == 255).all() and (i1[:, 600] == 255).all()
    assert (d2[:, 7] == 0).all() and (d1[:, 600] == 0).all()
    v1, v2 = tchamfer.nn_distance_values(torch.from_numpy(x1), torch.from_numpy(x2))
    j1, j2 = jchamfer.nn_distance_values(x1, x2, "direct")
    np.testing.assert_array_equal(v1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("b,n,m", [(1, 520, 300), (2, 300, 520)])
def test_payloads_plain_match_jax_kernel_with_ties_at_a_tile_boundary(b, n, m):
    """Ties at 255/256, the JAX kernel's 256-point tile boundary, on both
    clouds, and duplicated points that make segments of several j."""
    from geometric_adv_tpu.ops.pallas.chamfer_loss_kernel import chamfer_loss_payloads

    rng = np.random.RandomState(n + m)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x1[:, 256] = x1[:, 255] = x2[:, 7]
    x2[:, 256] = x2[:, 255] = x1[:, 9]
    x2[:, 100:110] = x1[:, 20, None]  # one segment of ten j
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in chamfer_loss_payloads(x1, x2)]
    got = [t.numpy() for t in tchamfer.chamfer_loss_payloads_plain(
        torch.from_numpy(x1), torch.from_numpy(x2))]
    names = ("d1", "i1", "d2", "i2", "nn1", "snn1", "cnt1")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name == "snn1":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)
        elif name in ("d1", "d2"):
            # the interpreter's XLA:CPU code contracts the distance into
            # FMAs (tests/test_torch_ops_chamfer_fused.py)
            np.testing.assert_array_max_ulp(g, w, maxulp=2)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[3][:, 7] == 255).all() and (got[1][:, 9] == 255).all()
    assert (got[6][:, 20] >= 10).all()


@pytest.mark.parametrize("b,n,m", [(2, 70, 50), (1, 300, 2500), (2, 1100, 300)])
def test_plain_snn1_is_an_ascending_j_loop(b, n, m):
    """K5 sums each segment in ascending j from 0.0f; its plain version
    (the card's test oracle) must hold the same bits."""
    rng = np.random.RandomState(b * n + m)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x2[:, : m // 3] = x2[:, m // 3: 2 * (m // 3)] * np.float32(1.0 + 2**-20)  # long segments
    _, _, _, i2, _, snn1, cnt1 = (t.numpy() for t in tchamfer.chamfer_loss_payloads_plain(
        torch.from_numpy(x1), torch.from_numpy(x2)))
    want = np.zeros((b, n, 3), np.float32)
    count = np.zeros((b, n), np.float32)
    for bi in range(b):
        for j in range(m):
            want[bi, i2[bi, j]] += x2[bi, j]
            count[bi, i2[bi, j]] += np.float32(1.0)
    np.testing.assert_array_equal(snn1, want)
    np.testing.assert_array_equal(cnt1, count)
    assert count.max() > 1


def grad1_loop(x1, x2, i1, i2, g1, g2):
    """K3's output as the redesigned kernel forms it: each scatter term
    (2*g2[j]) * (x2[j] - x1[i]) added to i's sum in ascending j from 0.0f,
    then (2*g1) * (x1 - x2[idx1]) less the sum; float32 throughout."""
    b, n, _ = x1.shape
    two = np.float32(2.0)
    out = np.empty_like(x1)
    for bi in range(b):
        s = np.zeros((n, 3), np.float32)
        for j, i in enumerate(i2[bi]):
            if 0 <= i < n:
                s[i] += (two * g2[bi, j]) * (x2[bi, j] - x1[bi, i])
        out[bi] = (two * g1[bi])[:, None] * (x1[bi] - x2[bi, i1[bi]]) - s
    return out


def grad1_vpu_loop(x1, x2, i1, i2, g1, g2):
    """K4's output as its segmented pass forms it: with w = 2*g2[j], sc += w*x2[j]
    and cnt += w added to i's sums in ascending j from 0.0f, the gather
    0.0f + x2[idx1], then (2*g1*(x1 - gath) - sc) + x1*cnt; float32
    throughout."""
    b, n, _ = x1.shape
    two, zero = np.float32(2.0), np.float32(0.0)
    out = np.empty_like(x1)
    for bi in range(b):
        sc = np.zeros((n, 3), np.float32)
        cnt = np.zeros((n, 1), np.float32)
        for j, i in enumerate(i2[bi]):
            if 0 <= i < n:
                w = two * g2[bi, j]
                sc[i] += x2[bi, j] * w
                cnt[i] += w
        gath = zero + x2[bi, i1[bi]]
        out[bi] = ((two * g1[bi])[:, None] * (x1[bi] - gath) - sc) + x1[bi] * cnt
    return out


GRAD1_CASES = [("ties", 2, 2048, 2048), ("ties", 1, 2500, 2048),
               ("clustered", 2, 300, 2500), ("clustered", 2, 2048, 600)]


def grad1_inputs(kind, b, n, m):
    """Tie clouds, or clouds whose x2 clusters on three x1 points (segments
    of hundreds of j, every other point's segment empty), with uniform
    weights and the plain argmins."""
    rng = np.random.RandomState(b * n + m)
    if kind == "ties":
        x1, x2 = straddling_ties(b, n, m, seed=n + m)
    else:
        x1 = rng.rand(b, n, 3).astype(np.float32)
        x2 = (x1[:, rng.randint(0, 3, m)] + 1e-3 * rng.rand(b, m, 3)).astype(np.float32)
    g1 = rng.rand(b, n).astype(np.float32)
    g2 = rng.rand(b, m).astype(np.float32)
    _, i1, _, i2 = (t.numpy() for t in tchamfer.nn_distance_plain(
        torch.from_numpy(x1), torch.from_numpy(x2)))
    counts = np.stack([np.bincount(i, minlength=n) for i in i2])
    if kind == "clustered":
        assert counts.max() >= 100 and (counts == 0).mean() > 0.5
    else:
        assert counts.max() >= 2
    return x1, x2, i1, i2, g1, g2


@pytest.mark.parametrize("kind,b,n,m", GRAD1_CASES)
def test_plain_grad1_is_an_ascending_j_loop(kind, b, n, m):
    """K3 sums each point's scatter terms in ascending j from 0.0f; its
    plain version (the card's test oracle) must hold the same bits, on tie
    clouds and on clouds whose x2 clusters on three x1 points."""
    args = grad1_inputs(kind, b, n, m)
    got = tchamfer.chamfer_grad1_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), grad1_loop(*args))


@pytest.mark.parametrize("kind,b,n,m", GRAD1_CASES)
def test_plain_grad1_vpu_is_an_ascending_j_loop(kind, b, n, m):
    """K4 adds each point's sc and cnt terms in ascending j from 0.0f, in
    its own algebra; its plain version (the card's test oracle) must hold
    the same bits, on the same clouds as K3's."""
    args = grad1_inputs(kind, b, n, m)
    got = tchamfer.chamfer_grad1_vpu_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), grad1_vpu_loop(*args))
