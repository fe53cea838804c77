"""The port's metro eval (geometric_adv_tpu_torch/transfer/metro.py) against
the JAX package's, on the CPU.

Bars: ``square_grid_faces`` and ``merge_patch_meshes`` equal;
``hausdorff_sampled`` on the JAX package's own samples within rtol 1e-6 of
its value; the CPU route's row-chunked K2 plain version bit-equal to the
unchunked one; the sampler's points on their triangles and spread in
proportion to area (as tests/test_metro.py:44-97 hold the JAX sampler); a
known-offset mesh pair recovering its distance (tests/test_metro.py:57);
AtlasNet's generated mesh from bridged weights equal to the JAX package's
(vertices atol 1e-5, faces equal), and ``metro_eval`` on it at 300 samples.
"""

import jax
import numpy as np
import pytest
import torch

from geometric_adv_tpu.transfer import metro as jax_metro
from geometric_adv_tpu.transfer.trainers import AtlasNetTrainer as JaxAtlas
from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.ops.chamfer import nn_distance_values_plain
from geometric_adv_tpu_torch.transfer import metro
from geometric_adv_tpu_torch.transfer.trainers import AtlasNetTrainer


def unit_square_mesh():
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    faces = np.asarray([[0, 1, 2], [1, 3, 2]], np.int32)
    return verts, faces


@pytest.mark.parametrize("grain", [2, 5, 8])
def test_grid_faces_and_merge_match_jax(grain):
    np.testing.assert_array_equal(metro.square_grid_faces(grain),
                                  jax_metro.square_grid_faces(grain))
    pts = np.random.RandomState(grain).rand(3, grain * grain, 3).astype(np.float32)
    faces = metro.square_grid_faces(grain)
    for got, want in zip(metro.merge_patch_meshes(pts, faces),
                         jax_metro.merge_patch_meshes(pts, faces)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_hausdorff_on_jax_samples_matches_jax():
    rng = np.random.RandomState(0)
    verts = rng.rand(3, 16, 3).astype(np.float32)
    mesh = metro.merge_patch_meshes(verts, metro.square_grid_faces(4))
    s1 = jax_metro.sample_mesh_surface(*mesh, 700, jax.random.PRNGKey(1))
    s2 = jax_metro.sample_mesh_surface(*unit_square_mesh(), 1300, jax.random.PRNGKey(2))
    want = float(jax_metro.hausdorff_sampled(s1, s2))
    got = float(metro.hausdorff_sampled(torch.tensor(np.asarray(s1)),
                                        torch.tensor(np.asarray(s2))))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("n,m,chunk", [(37, 53, 8), (2500, 300, 1024), (5, 9, 16)])
def test_chunked_values_bit_equal_to_plain(n, m, chunk):
    rng = np.random.RandomState(n)
    a = torch.from_numpy(rng.rand(2, n, 3).astype(np.float32))
    b = torch.from_numpy(rng.rand(2, m, 3).astype(np.float32))
    b[:, 3] = a[:, 0]  # an exact zero
    for got, want in zip(metro.nn_distance_values_chunked(a, b, chunk),
                         nn_distance_values_plain(a, b)):
        assert torch.equal(got, want)


def test_sampler_on_surface_and_area_weighted():
    """Two triangles of areas 1/2 and 1/8: every sample lies on its
    triangle's plane inside it, and the share in each is its share of the
    area (4/5, 1/5) within sampling error."""
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                        [0, 0, 1], [0.5, 0, 1], [0, 0.5, 1]], np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    gen = torch.Generator().manual_seed(0)
    s = metro.sample_mesh_surface(verts, faces, 20000, gen, "cpu").numpy()
    assert s.shape == (20000, 3)
    low = s[:, 2] == 0
    assert (low | (s[:, 2] == 1)).all()
    assert abs(low.mean() - 0.8) < 0.01
    assert (s[:, :2] >= 0).all()
    assert (s[low, 0] + s[low, 1] <= 1 + 1e-6).all()
    assert (s[~low, 0] + s[~low, 1] <= 0.5 + 1e-6).all()
    sq = metro.sample_mesh_surface(*unit_square_mesh(), 4000, gen, "cpu").numpy()
    assert abs(sq[:, 0].mean() - 0.5) < 0.02 and abs(sq[:, 1].mean() - 0.5) < 0.02
    degenerate = np.asarray([[0, 1, 2], [0, 0, 1]], np.int32)  # zero area
    d = metro.sample_mesh_surface(verts, degenerate, 2000, gen, "cpu").numpy()
    assert (d[:, 2] == 0).all()


def test_metro_distance_recovers_a_known_offset():
    verts, faces = unit_square_mesh()
    shifted = verts + np.asarray([0.0, 0.0, 0.25], np.float32)
    d = metro.metro_distance(verts, faces, shifted, faces, n_samples=4000,
                             device="cpu")
    np.testing.assert_allclose(d, 0.25, atol=0.02)  # parallel planes
    assert metro.metro_distance(verts, faces, verts, faces, n_samples=4000,
                                device="cpu") < 0.05
    a, b = torch.zeros(4, 3), torch.zeros(4, 3)
    b[0] = torch.tensor([3.0, 4.0, 0.0])
    assert float(metro.hausdorff_sampled(a, b)) == 5.0


def test_atlasnet_mesh_matches_jax_and_metro_eval_runs():
    jt = JaxAtlas(number_points=64, nb_primitives=4, template_type="SQUARE",
                  n_points_input=32)
    pt = AtlasNetTrainer(number_points=64, nb_primitives=4, template_type="SQUARE",
                         device="cpu")
    pt.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, jt.state.params),
        jax.tree.map(np.asarray, jt.state.batch_stats)))
    cloud = np.random.RandomState(0).rand(32, 3).astype(np.float32) - 0.5
    verts, faces = metro.atlasnet_generate_mesh(pt, cloud)
    want_verts, want_faces = jax_metro.atlasnet_generate_mesh(jt, cloud)
    assert verts.shape == (64, 3) and faces.shape == (4 * 9 * 2, 3)
    np.testing.assert_array_equal(faces, want_faces)
    np.testing.assert_allclose(verts, want_verts, rtol=0, atol=1e-5)
    mean, per = metro.metro_eval(pt, [cloud, cloud], [unit_square_mesh()] * 2,
                                 n_samples=300)
    assert len(per) == 2 and np.isfinite(mean) and mean > 0
    with pytest.raises(ValueError, match="SQUARE"):
        metro.atlasnet_generate_mesh(AtlasNetTrainer(number_points=64, device="cpu"),
                                     cloud)
