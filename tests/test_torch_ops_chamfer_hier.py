"""The port's pruned chamfer (``ops/chamfer_hier.py``: the preparation and
the plain version of kernel K8) against the JAX package's
``chamfer_hier_kernel.py`` on the CPU, its Pallas kernel in interpreter mode
as tests/test_ops_chamfer.py:305-353 runs it.

Bars: Morton codes and the sort permutation equal; block spheres and upper
bounds rtol 1e-6; distances atol 1e-8 against the interpreter (its XLA:CPU
code contracts the distance into FMAs) and bit-equal to the port's
``nn_distance_plain``; indices equal.
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

    xs, perm_x, _ = thier._prep(x)
    ys, perm_y, cyr = thier._prep(y)
    ub = thier.seed_upper_bounds(xs, cyr)
    d, _ = thier.nn_direction_hier_plain(xs, ub, ys, perm_y, cyr)
    assert torch.equal(d, torch.gather(want[0], -1, perm_x.long()))
    shrunk = cyr.clone()
    shrunk[..., 3] = 0.0
    bad, _ = thier.nn_direction_hier_plain(xs, ub, ys, perm_y, shrunk)
    assert (bad > d).any()
