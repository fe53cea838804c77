"""The chunk-screened chamfer matrix (PARITY #14) of the port
(geometric_adv_tpu_torch/ops/pairwise.py) against the JAX package's
(geometric_adv_tpu/ops/pairwise.py:97-188, :268-313), on the CPU.

Bars: the "mxu" distance plane bit-equal to JAX's on these inputs; the
Morton-sorted chunks equal, their centers (means summed in another order)
at rtol 1e-6; with k = C the screened matrix equal to the exact one at rtol
1e-6, padded chunks included (m = 60, C = 8); the screened entries against
JAX's at the same C and k at rtol 1e-6, atol 1e-7: a chunk picked
differently at a near-tie of the centroid plane would give another,
still majorizing, entry, and the test names every entry beyond the bar;
every entry >= its exact value; the per-class neighbour heads of
``sort_dist_mat`` kept (tests/test_attack.py:320-344); the CLI's artifacts
equal to the JAX CLI's.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

from geometric_adv_tpu.data.synthetic import sample_shape
from geometric_adv_tpu.ops import pairwise as jp
from geometric_adv_tpu.ops.chamfer import pairwise_sqdist as jax_sqdist
from geometric_adv_tpu_torch.attack.pipeline import sort_dist_mat
from geometric_adv_tpu_torch.ops import pairwise as tp
from geometric_adv_tpu_torch.ops.chamfer import pairwise_sqdist


def surface_clouds(n_per=6, m=256):
    """tests/test_attack.py:293-304's cloud set (the screen's geometry)."""
    pcs, slice_idx = [], [0]
    for c in ("sphere", "cube", "torus"):
        for i in range(n_per):
            pcs.append(np.asarray(sample_shape(c, m, np.random.RandomState(i + 7))))
        slice_idx.append(len(pcs))
    return np.stack(pcs).astype(np.float32), np.array(slice_idx)


@pytest.mark.parametrize("n,m", [(50, 17), (256, 64)])
def test_mxu_distance_matches_jax(n, m):
    rng = np.random.RandomState(n)
    x = rng.rand(3, n, 3).astype(np.float32) - 0.5
    y = rng.rand(3, m, 3).astype(np.float32) - 0.5
    y[:, 0] = x[:, 0]  # a zero distance, clamped at 0 after cancellation
    got = pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y), method="mxu")
    want = np.asarray(jax_sqdist(x, y, method="mxu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all()


@pytest.mark.parametrize("m,c", [(256, 16), (60, 8), (64, 64)])
def test_chunk_clouds_matches_jax(m, c):
    pcs, _ = surface_clouds(n_per=2, m=m)
    pcs[0, 10] = pcs[0, 20]  # equal Morton keys keep their point order
    want_chunks, want_centers = (np.asarray(a) for a in jp.chunk_clouds(pcs, c))
    chunks, centers = tp.chunk_clouds(torch.from_numpy(pcs), c)
    assert chunks.shape == (len(pcs), c, -(-m // c), 3)
    np.testing.assert_array_equal(chunks.numpy(), want_chunks)
    np.testing.assert_allclose(centers.numpy(), want_centers, rtol=1e-6, atol=1e-7)


def test_screened_full_coverage_equals_exact():
    pcs, _ = surface_clouds(n_per=3, m=60)  # 60 % 8 != 0: padded chunks
    exact = tp.chamfer_distance_matrix(pcs, "cpu", pair_block=16)
    scr = tp.chamfer_distance_matrix(pcs, "cpu", pair_block=16, screen_chunks=8,
                                     screen_k=8)
    np.testing.assert_allclose(scr, exact, rtol=1e-6, atol=0)


@pytest.mark.parametrize("c,k", [(16, 6), (8, 2), (32, 4)])
def test_screened_matrix_matches_jax_and_majorizes(c, k):
    pcs, slice_idx = surface_clouds(n_per=6, m=256)
    want = jp.chamfer_distance_matrix(pcs, pair_block=32, screen_chunks=c, screen_k=k)
    got = tp.chamfer_distance_matrix(pcs, "cpu", pair_block=32, screen_chunks=c,
                                     screen_k=k)
    far = ~np.isclose(got, want, rtol=1e-6, atol=1e-7)
    assert not far.any(), (
        f"entries beyond the bar: {list(zip(*np.nonzero(far)))}, port "
        f"{got[far]}, JAX {want[far]}")
    exact = tp.chamfer_distance_matrix(pcs, "cpu")
    assert np.all(got >= exact)
    nn_e = sort_dist_mat(exact.copy(), slice_idx)
    nn_s = sort_dist_mat(got.copy(), slice_idx)
    hits = 0
    for i in range(len(pcs)):
        for j in range(len(slice_idx) - 1):
            block = slice(slice_idx[j], slice_idx[j + 1])
            hits += len(set(nn_e[i, block][:3]) & set(nn_s[i, block][:3]))
    assert hits / (3 * len(pcs) * (len(slice_idx) - 1)) > 0.9


def test_screen_k_defaults_and_caps():
    """screen_k 0 means 8, and k is capped at C (k = 12 > C = 4 scans all)."""
    pcs, _ = surface_clouds(n_per=2, m=64)
    exact = tp.chamfer_distance_matrix(pcs, "cpu")
    capped = tp.chamfer_distance_matrix(pcs, "cpu", screen_chunks=4, screen_k=12)
    np.testing.assert_allclose(capped, exact, rtol=1e-6, atol=0)
    default = tp.chamfer_distance_matrix(pcs, "cpu", screen_chunks=16)
    eight = tp.chamfer_distance_matrix(pcs, "cpu", screen_chunks=16, screen_k=8)
    np.testing.assert_array_equal(default, eight)


def test_prepare_indices_screened_cli_matches_jax(tmp_path, monkeypatch):
    """prepare_indices_for_attack --chamfer_screen_chunks/--chamfer_screen_k:
    the port's CLI writes the JAX CLI's screened matrix and NN indices."""
    from geometric_adv_tpu.cli import prepare_indices_for_attack as jax_cli
    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack as port_cli

    pcs, slice_idx = surface_clouds(n_per=5, m=128)
    for ae in ("jax", "port"):
        ev = tmp_path / ae / "eval"
        ev.mkdir(parents=True)
        np.save(ev / "point_clouds_test_set_13l.npy", pcs)
        np.save(ev / "latent_vectors_test_set_13l.npy",
                pcs.reshape(len(pcs), -1)[:, :16])
        np.save(ev / "pc_classes_13l.npy", np.array(["sphere", "cube", "torus"]))
        np.save(ev / "slice_idx_test_set_13l.npy", slice_idx)
    flags = ["--project_dir", str(tmp_path), "--get_chamfer_nn_idx", "1",
             "--chamfer_screen_chunks", "16", "--chamfer_screen_k", "3"]
    monkeypatch.setattr(sys, "argv", ["stage", "--ae_folder", "jax", *flags])
    jax_cli.main()
    port_cli.main(["--ae_folder", "port", "--device", "cpu", *flags])
    out = {ae: [np.load(osp.join(tmp_path, ae, "eval", f"{name}_test_set_13l.npy"))
                for name in ("chamfer_dist_mat_complete", "chamfer_nn_idx_complete")]
           for ae in ("jax", "port")}
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
