"""The port's defenses (geometric_adv_tpu_torch/defense/, the trainer's
pre-symmetry reductions) against the JAX package's, on the CPU.

Bars: the host-numpy copies bit-equal to their originals on the same inputs
(count ties in the critical points, clouds with no outlier and with only
outliers); ``knn_dists_per_point`` at rtol 1e-6 (the squared distances and
indices agree exactly; the JAX package's jitted root may differ by an ulp
from the port's correctly rounded one); the pre-symmetry map from bridged weights
at 1e-5 and its per-channel argmax exact, the argmax test naming the JAX
margin of any channel that flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_adv_tpu.defense import critical as o_crit
from geometric_adv_tpu.defense import surface as o_surf
from geometric_adv_tpu_torch.defense import critical as c_crit
from geometric_adv_tpu_torch.defense import surface as c_surf


def pre_symmetry_like(rng, num_pc, n, bneck):
    """ReLU-like features with dead channels and points that win several
    channels, so that the count sort meets ties."""
    pre = np.maximum(rng.randn(num_pc, n, bneck).astype(np.float32), 0.0)
    pre[:, :, 0] = 0.0  # a dead channel
    pre[:, 3, 1:4] = 9.0  # point 3 wins three channels
    pre[:, 7, 4:6] = 9.0  # points 7 and 8 two each: a tie in the counts
    pre[:, 8, 6:8] = 9.0
    return pre


@pytest.mark.parametrize("num_pc,n,bneck", [(4, 32, 16), (3, 50, 64)])
def test_critical_point_copies_are_bit_equal(num_pc, n, bneck):
    rng = np.random.RandomState(bneck)
    pcs = rng.rand(num_pc, n, 3).astype(np.float32)
    pre = pre_symmetry_like(rng, num_pc, n, bneck)
    for a, b in zip(c_crit.get_critical_points(pcs, pre),
                    o_crit.get_critical_points(pcs, pre)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    reduced = dict(max_idx_all=pre.argmax(axis=1), max_val_all=pre.max(axis=1))
    for a, b in zip(c_crit.get_critical_pc_non_critical_pc(pcs, **reduced),
                    o_crit.get_critical_pc_non_critical_pc(pcs, **reduced)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    idx = np.array([0, 5, n - 1])
    np.testing.assert_array_equal(c_crit._complementary_idx(idx, n),
                                  o_crit._complementary_idx(idx, n))


@pytest.mark.parametrize("thresh", [0.0, 0.05, 0.2, 10.0])
def test_outlier_inlier_copy_is_bit_equal(thresh):
    """At 0.0 every point is an outlier, at 10.0 none is."""
    rng = np.random.RandomState(1)
    pcs = rng.rand(3, 40, 3).astype(np.float32)
    dists = rng.rand(3, 40).astype(np.float32) * 0.3
    for a, b in zip(c_surf.get_outlier_pc_inlier_pc(pcs, dists, thresh),
                    o_surf.get_outlier_pc_inlier_pc(pcs, dists, thresh)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_pc,n,k,batch", [(5, 64, 8, 2), (3, 100, 4, 100)])
def test_knn_dists_per_point_matches_jax(num_pc, n, k, batch):
    rng = np.random.RandomState(n)
    pcs = rng.rand(num_pc, n, 3).astype(np.float32)
    pcs[:, 1] = pcs[:, 9]  # duplicates: a zero distance besides the self
    want = o_surf.knn_dists_per_point(pcs, num_knn=k, batch_size=batch)
    got = c_surf.knn_dists_per_point(pcs, "cpu", num_knn=k, batch_size=batch)
    assert got.shape == want.shape == (num_pc, n, k) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[:, 1, 0] == 0).all()


def bridged_trainers(n=64, bneck=16):
    """A JAX AETrainer (flax init, seed 42) and the port's with its weights."""
    from geometric_adv_tpu.train import AETrainer as JaxTrainer
    from geometric_adv_tpu.train.config import Configuration as JaxConf
    from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    jax_trainer = JaxTrainer(JaxConf(n_input=[n, 3], bneck_size=bneck))
    port = AETrainer(Configuration(n_input=[n, 3], bneck_size=bneck), "cpu")
    port.model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, jax_trainer.state.params),
        jax.tree.map(np.asarray, jax_trainer.state.batch_stats)))
    return jax_trainer, port


def test_pre_symmetry_reductions_match_jax():
    jax_trainer, port = bridged_trainers()
    pcs = np.random.RandomState(0).rand(7, 64, 3).astype(np.float32) - 0.5
    want_pre = jax_trainer.get_pre_symmetry_data(pcs, batch_size=3)
    got_pre = port.get_pre_symmetry_data(pcs, batch_size=3)
    np.testing.assert_allclose(got_pre, want_pre, rtol=1e-5, atol=1e-5)
    want_idx, want_val = jax_trainer.get_pre_symmetry_argmax(pcs, batch_size=3)
    got_idx, got_val = port.get_pre_symmetry_argmax(pcs, batch_size=3)
    assert got_idx.dtype == want_idx.dtype == np.int32
    flips = np.argwhere(got_idx != want_idx)
    margins = [
        float(want_pre[c, want_idx[c, ch], ch] - want_pre[c, got_idx[c, ch], ch])
        for c, ch in flips
    ]
    assert not len(flips), f"argmax flips at (cloud, channel) {flips.tolist()}, " \
                           f"JAX margins {margins}"
    np.testing.assert_allclose(got_val, want_val, rtol=1e-5, atol=1e-5)
    # the argmax of a tie is its first index, as jnp.argmax's
    tied = jnp.zeros((1, 5, 2)).at[0, 1:4, :].set(1.0)
    torch_tied = torch.zeros(1, 5, 2)
    torch_tied[0, 1:4] = 1.0
    assert torch_tied.argmax(dim=-2).tolist() == np.asarray(
        jnp.argmax(tied, axis=-2)).tolist() == [[1, 1]]


def test_knn_dists_take_the_correctly_rounded_root():
    """The distances are float32's correctly rounded square roots of the
    squared distances (numpy's float32 sqrt is IEEE), which PyTorch's float32
    CPU sqrt does not always give, so that the card and the host agree bit
    for bit."""
    from geometric_adv_tpu_torch.ops.grouping import knn_point

    pcs = np.random.RandomState(3).rand(4, 200, 3).astype(np.float32) * 4
    got = c_surf.knn_dists_per_point(pcs, "cpu", num_knn=6)
    sqd, _ = knn_point(7, torch.from_numpy(pcs), torch.from_numpy(pcs))
    np.testing.assert_array_equal(got, np.sqrt(sqd[..., 1:].numpy()))
