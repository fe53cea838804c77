"""The port's grouping ops (geometric_adv_tpu_torch/ops/grouping.py) against
the JAX package's (geometric_adv_tpu/ops/grouping.py) on the same inputs, at
ragged sizes with duplicate points, so that equal distances occur and must
go to the lower index as ``lax.top_k`` and the stable sorts send them.

Bars: indices and counts exact; distances bit-equal, both packages forming
the same "direct" sum here (XLA may contract it into FMAs elsewhere, which
rtol 1e-6 would allow); group_point's gradient within 1e-6
of JAX's VJP (a scatter-add of the same values, in either order).
"""

import jax
import numpy as np
import pytest
import torch

from geometric_adv_tpu.ops import grouping as jg
from geometric_adv_tpu_torch.ops import grouping as tg

SIZES = [(2, 37, 29, 5), (3, 16, 16, 16), (1, 100, 7, 9), (2, 64, 64, 1)]


def clouds_with_ties(b, n, m, seed):
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x1[:, 3] = x1[:, 11]  # a duplicated dataset point
    x1[:, 5] = x1[:, 2]
    x2[:, 1] = x1[:, 3]  # a query on both copies
    x2[:, 0] = x2[:, m - 1]
    return x1, x2


@pytest.mark.parametrize("b,n,m,k", SIZES)
def test_knn_point_matches_jax(b, n, m, k):
    x1, x2 = clouds_with_ties(b, n, m, seed=n + m)
    want_d, want_i = (np.asarray(a) for a in jg.knn_point(k, x1, x2))
    got_d, got_i = tg.knn_point(k, torch.from_numpy(x1), torch.from_numpy(x2))
    assert got_i.dtype == torch.int32 and got_d.shape == (b, m, k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    # the query on both copies of a duplicated point: the lower index first
    assert (got_i[:, 1, :2].numpy() == [3, 11][:k]).all()


@pytest.mark.parametrize("b,n,m,k", SIZES[:3])
def test_knn_point_blocks_of_queries_change_nothing(b, n, m, k, monkeypatch):
    x1, x2 = (torch.from_numpy(a) for a in clouds_with_ties(b, n, m, seed=1))
    whole = tg.knn_point(k, x1, x2)
    monkeypatch.setattr(tg, "KNN_BLOCK_ELEMS", 3 * n)  # 3 queries a block
    blocked = tg.knn_point(k, x1, x2)
    for a, c in zip(whole, blocked):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,n,m,k", SIZES[:3])
def test_select_top_k_matches_jax(b, n, m, k):
    rng = np.random.RandomState(n)
    d = rng.rand(b, m, n).astype(np.float32)
    d[..., 3] = d[..., 7]
    d[..., n - 1] = d[..., 0]
    want_i, want_d = (np.asarray(a) for a in jg.select_top_k(k, d))
    got_i, got_d = tg.select_top_k(k, torch.from_numpy(d))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


@pytest.mark.parametrize("b,n,c,m,s", [(2, 30, 5, 7, 3), (1, 64, 3, 64, 9)])
def test_group_point_and_gradient_match_jax(b, n, c, m, s):
    rng = np.random.RandomState(c)
    points = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, size=(b, m, s)).astype(np.int32)
    idx[:, 0, :] = 2  # a point gathered many times: its gradient sums them
    g = rng.randn(b, m, s, c).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jg.group_point(p, idx), points)
    p = torch.from_numpy(points).requires_grad_(True)
    got = tg.group_point(p, torch.from_numpy(idx))
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(vjp(g)[0]), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("radius,nsample", [(0.05, 3), (0.2, 4), (0.5, 8)])
@pytest.mark.parametrize("b,n,m,k", SIZES[:3])
def test_query_ball_point_matches_jax(radius, nsample, b, n, m, k):
    """First-hit padding, and the rows with no hit all zeros with count 0
    (at radius 0.05 most rows have none)."""
    x1, x2 = clouds_with_ties(b, n, m, seed=2)
    want_i, want_c = (np.asarray(a) for a in jg.query_ball_point(radius, nsample, x1, x2))
    got_i, got_c = tg.query_ball_point(radius, nsample, torch.from_numpy(x1),
                                       torch.from_numpy(x2))
    assert got_i.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
