"""The port's pruned chamfer (``ops/chamfer_hier.py``: the preparation and
the plain version of kernel K8) against the JAX package's
``chamfer_hier_kernel.py`` on the CPU, its Pallas kernel in interpreter mode
as tests/test_ops_chamfer.py:305-353 runs it.

Bars: Morton codes and the sort permutation equal; block spheres and upper
bounds rtol 1e-6; distances atol 1e-8 against the interpreter (its XLA:CPU
code contracts the distance into FMAs) and bit-equal to the port's
``nn_distance_plain``; indices equal. The packed-key minimum is pinned to
the two-branch rule it replaced, and the NaN rule to its documentation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geometric_adv_tpu.ops.pallas import chamfer_hier_kernel as jhier
from geometric_adv_tpu_torch.ops import chamfer as tchamfer
from geometric_adv_tpu_torch.ops import chamfer_hier as thier


def tie_clouds(seed=0, b=3, n=300, m=257):
    """tests/test_ops_chamfer.py:318-326's clouds: ragged sizes, exact
    duplicates in both directions and a zero-distance pair."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, n, 3) - 0.5).astype(np.float32)
    y = (rng.rand(b, m, 3) - 0.5).astype(np.float32)
    y[0, 100] = y[0, 7]
    y[1, 5] = y[1, 200]
    x[2, 50] = x[2, 3]
    x[0, 10] = y[0, 7]
    return x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_codes_and_sort_match_jax(seed):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(2, 300, 3) - 0.5).astype(np.float32)
    pts[:, 40] = pts[:, 3]  # equal codes: the stable order must agree
    pts[1, :, 2] = 0.25  # a flat axis: the box's clamp
    want = np.asarray(jhier.morton_codes(jnp.asarray(pts))).astype(np.int64)
    got = thier.morton_codes(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    js, jperm = jhier.sort_cloud(jnp.asarray(pts))
    ts, tperm = thier.sort_cloud(torch.from_numpy(pts))
    assert tperm.dtype == torch.int32
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_block_spheres_and_upper_bounds_match_jax():
    x, y = tie_clouds(n=200, m=384)  # three full blocks
    ys, _ = thier.sort_cloud(torch.from_numpy(y))
    cyr = thier.build_block_structure(ys)
    _, jcyr = jhier.build_block_structure(jnp.asarray(ys.numpy()), thier.BS)
    assert cyr.shape == (3, 3, 4)
    np.testing.assert_allclose(cyr.numpy(), np.swapaxes(np.asarray(jcyr), -1, -2),
                               rtol=1e-6)
    ub = thier.seed_upper_bounds(torch.from_numpy(x), cyr)
    jub = jhier.seed_upper_bounds(jnp.asarray(x), jcyr)
    np.testing.assert_allclose(ub.numpy(), np.asarray(jub), rtol=1e-6)
    d1, _, _, _ = tchamfer.nn_distance_plain(torch.from_numpy(x), ys)
    assert (ub >= d1).all()  # a true upper bound


def test_ragged_last_block_sphere_holds_its_points():
    """The JAX package pads the last block with 1e9 points (a sphere that
    never prunes); the port's last sphere is that of its own points."""
    _, y = tie_clouds(n=60, m=300)
    ys, _ = thier.sort_cloud(torch.from_numpy(y))
    cyr = thier.build_block_structure(ys)
    assert cyr.shape == (3, 3, 4)
    last = ys[:, 256:]
    dist = ((last - cyr[:, None, 2, :3]) ** 2).sum(-1).sqrt()
    assert (dist <= cyr[:, None, 2, 3]).all()
    assert (cyr[..., 3] < 2.0).all()


def test_nn_distance_hier_matches_jax_kernel_and_nn_distance():
    x, y = tie_clouds()
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jax.jit(jhier.nn_distance_hier)(x, y)]
    got = [t.numpy() for t in thier.nn_distance_hier(torch.from_numpy(x),
                                                      torch.from_numpy(y))]
    plain = [t.numpy() for t in tchamfer.nn_distance_plain(torch.from_numpy(x),
                                                            torch.from_numpy(y))]
    for k, (g, w, p) in enumerate(zip(got, want, plain)):
        assert g.shape == w.shape
        if k % 2:
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-8)
        np.testing.assert_array_equal(g, p)
    assert got[1][0, 10] == 7  # the zero-distance pair, first of the duplicates


def test_direction_without_indices_returns_none():
    x, y = tie_clouds()
    d, i = thier.nn_direction_sorted(torch.from_numpy(x), torch.from_numpy(y),
                                     with_idx=False)
    assert i is None
    np.testing.assert_array_equal(
        d.numpy(), tchamfer.nn_distance_plain(torch.from_numpy(x),
                                              torch.from_numpy(y))[0].numpy())
    with pltpu.force_tpu_interpret_mode():
        jd, ji = jax.jit(lambda a, b: jhier.nn_direction_sorted(
            a, b, with_idx=False))(x, y)
    assert ji is None
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-8)


def test_surface_clouds_stay_exact_and_bounds_are_used():
    """On the synthetic dataset's surface clouds the result is still
    nn_distance's. With spheres shrunk to their centres the bounds are
    false and the plain version prunes argmins and goes wrong: it really
    runs the bound test, so a bound that pruned the argmin would fail here
    too."""
    from geometric_adv_tpu_torch.data.synthetic import sample_shape

    rng = np.random.RandomState(2)
    clouds = [np.stack([sample_shape(s, 512, rng) for s in ("sphere", "torus")])
              .astype(np.float32) for _ in range(2)]
    x, y = (torch.from_numpy(c) for c in clouds)
    want = tchamfer.nn_distance_plain(x, y)
    for g, w in zip(thier.nn_distance_hier(x, y), want):
        assert torch.equal(g, w)

    (x4, _), (y4, cyr) = thier.prepare(x, y)
    d, _ = thier.nn_direction_hier_plain(x4, y4, cyr)
    assert torch.equal(d, want[0])
    shrunk = cyr.clone()
    shrunk[..., 3] = 0.0
    bad, _ = thier.nn_direction_hier_plain(x4, y4, shrunk)
    assert (bad > d).any()


def ragged_tie_clouds(seed, b, n, m):
    """Uniform clouds of any size with exact ties where the sizes allow: a
    duplicated point of y, a query on it, a duplicated query."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, n, 3) - 0.5).astype(np.float32)
    y = (rng.rand(b, m, 3) - 0.5).astype(np.float32)
    y[:, 200] = y[:, 7]
    x[:, 0] = y[:, 7]
    if n > 100:
        x[:, 100] = x[:, 3]
    return x, y


# the interpreter's FMAs move a distance by up to an ulp or two, 1.2e-7 at
# n = 1, whose y -> x distances reach 1.24
FMA_RTOL = 2.5e-7
RAGGED = [(n, m) for n in (1, 127, 129, 300) for m in (257, 384)]


@pytest.mark.parametrize("n,m", RAGGED)
def test_plain_direction_matches_jax_kernel_and_nn_distance(n, m):
    """The plain direction, at the kernel's vote of one warp (NT = 32
    queries), on unsorted queries against the JAX kernel in interpret mode
    and the port's nn_distance_plain."""
    assert thier.NT == 32
    x, y = ragged_tie_clouds(n + m, 2, n, m)
    d, i = thier.nn_direction_sorted(torch.from_numpy(x), torch.from_numpy(y))
    with pltpu.force_tpu_interpret_mode():
        jd, ji = jax.jit(jhier.nn_direction_sorted)(x, y)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=FMA_RTOL, atol=1e-8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    want = tchamfer.nn_distance_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(d, want[0]) and torch.equal(i, want[1])
    assert (i[:, 0] == 7).all()  # on the duplicated point, its first id


@pytest.mark.parametrize("n,m", RAGGED)
def test_plain_op_in_original_order_matches_jax_kernel_and_nn_distance(n, m):
    """nn_distance_hier's path through prepared clouds, whose results the
    direction writes at the original ids, against the JAX op in interpret
    mode and nn_distance_plain."""
    x, y = ragged_tie_clouds(n * m, 2, n, m)
    got = thier.nn_distance_hier(torch.from_numpy(x), torch.from_numpy(y))
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jax.jit(jhier.nn_distance_hier)(x, y)]
    plain = tchamfer.nn_distance_plain(torch.from_numpy(x), torch.from_numpy(y))
    for k, (g, w, p) in enumerate(zip(got, want, plain)):
        if k % 2:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=FMA_RTOL, atol=1e-8)
        assert torch.equal(g, p)


def two_branch(cur, icur, d, ids):
    """The rule the kernel kept before its packed key: a closer point takes
    over, an equal one keeps the lower original id."""
    for dj, j in zip(d, ids):
        if dj < cur:
            cur, icur = dj, j
        elif dj == cur:
            icur = min(icur, j)
    return cur, icur


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_key_rule_matches_the_two_branch_rule(seed):
    """One 64-bit minimum of (bits of d) << 32 | id, started at (ub, 2^30),
    gives the two-branch rule's value and id on sequences full of equal
    distances, of distances equal to ub and above it."""
    rng = np.random.RandomState(seed)
    d = (rng.randint(0, 6, (64, 40)) * 0.25).astype(np.float32)
    ids = np.stack([rng.permutation(1000)[:40] for _ in range(64)]).astype(np.int32)
    ub = (rng.randint(0, 8, 64) * 0.25).astype(np.float32)
    ub[:4] = 0.0  # nothing below the start: it stays (ub, 2^30) or ties
    key = thier._pack(torch.from_numpy(ub), torch.full((64,), 2**30, dtype=torch.int32))
    keys = thier._pack(torch.from_numpy(d), torch.from_numpy(ids))
    got_d, got_i = thier._unpack(torch.minimum(key, keys.amin(dim=-1)))
    for r in range(64):
        cur, icur = two_branch(ub[r], 2**30, d[r], ids[r])
        assert (got_d[r].item(), got_i[r].item()) == (cur, icur)


def test_packed_key_direction_on_duplicate_points_matches_the_two_branch_scan():
    """The plain direction on clouds made of a few points each repeated
    many times (ties in every block) against the two-branch rule over every
    sorted point, the former kernel's scan without the pruning."""
    rng = np.random.RandomState(3)
    base = (rng.rand(2, 12, 3) - 0.5).astype(np.float32)
    y = torch.from_numpy(base[:, rng.randint(0, 12, 300)])
    x = torch.from_numpy(base[:, rng.randint(0, 12, 70)] + np.float32(0.01))
    d, i = thier.nn_direction_sorted(x, y)
    ((y4, cyr),) = thier.prepare(y)
    ub = thier.seed_upper_bounds(x, cyr)
    sqd = tchamfer.pairwise_sqdist(x, y4[..., :3])
    ids = thier.cloud_ids(y4)
    for c in range(2):
        for q in range(70):
            cur, icur = two_branch(ub[c, q].item(), 2**30, sqd[c, q].tolist(),
                                   ids[c].tolist())
            assert (d[c, q].item(), i[c, q].item()) == (cur, icur)


def test_nan_queries_and_points_follow_the_documented_rule():
    """A query with a NaN coordinate gets NaN and index 2^30; a NaN point
    of the other cloud (its sphere built before it went NaN) is never
    taken: the others get what they get with that point far away."""
    x, y = ragged_tie_clouds(5, 2, 90, 257)
    x[1, 33, 1] = np.nan
    (y4, cyr), = thier.prepare(torch.from_numpy(y))
    at = int((thier.cloud_ids(y4)[0] == 30).nonzero())
    far, nan4 = y4.clone(), y4.clone()
    far[0, at, :3] = 1e6
    nan4[0, at, :3] = float("nan")
    d, i = thier.nn_direction_hier_plain(torch.from_numpy(x), nan4, cyr)
    assert torch.isnan(d[1, 33]) and i[1, 33] == 2**30
    assert not torch.isnan(d[1, :33]).any() and not torch.isnan(d[0]).any()
    fd, fi = thier.nn_direction_hier_plain(torch.from_numpy(x), far, cyr)
    keep = ~torch.isnan(fd)
    assert torch.equal(d[keep], fd[keep]) and torch.equal(i, fi)
