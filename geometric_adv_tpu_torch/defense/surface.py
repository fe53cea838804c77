"""Off-surface (kNN distance) defense (``geometric_adv_tpu/defense/
surface.py``).

Adversarial perturbations push points off the shape surface; a point whose
mean distance to its 2 nearest neighbors (of 8 computed) exceeds 0.04 is
removed as an outlier, the remainder re-encoded
(reference: defender/get_knn_dists_per_point.py:73-83,
defender/run_defense_surface.py:32-33,187-191,
src/adversary_utils.py:149-178).

The kNN distances run on the device through the port's ``knn_point``; the
outlier/inlier split is a host-numpy copy of the JAX package's, pinned to
it by ``tests/test_torch_defense.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from geometric_adv_tpu_torch.ops.grouping import knn_point


@torch.no_grad()
def knn_dists_per_point(
    point_clouds, device, num_knn: int = 8, batch_size: int = 100
) -> np.ndarray:
    """True (sqrt) L2 distance from each point to its num_knn nearest
    neighbors within its own cloud, ascending, self excluded, in batches of
    ``batch_size`` clouds on ``device``.

    reference: defender/get_knn_dists_per_point.py:73-83 (knn_point with
    k+1 against itself, drop the self column, sqrt of squared dists).

    The square root is taken in float64 and rounded once to float32, which
    gives float32's correctly rounded root on every device (PyTorch's CPU
    float32 ``sqrt`` is not: 0.6% of uniform inputs came out 1 ulp off),
    so that the card and the host agree bit for bit.
    """
    out = []
    pcs = np.asarray(point_clouds, np.float32)
    for s in range(0, len(pcs), batch_size):
        batch = torch.as_tensor(pcs[s : s + batch_size], device=device)
        sqd, _ = knn_point(num_knn + 1, batch, batch)
        root = torch.sqrt(torch.clamp_min(sqd[..., 1:], 0.0).double()).float()
        out.append(root.cpu().numpy())
    return np.concatenate(out)


def get_outlier_pc_inlier_pc(point_clouds, knn_dists, knn_dist_thresh):
    """Split each cloud into outliers (> thresh) and inliers (<= thresh),
    both padded to full size by duplicating the last point.

    reference: src/adversary_utils.py:149-178.
    """
    num_pc, num_points, _ = point_clouds.shape

    outlier_pc = np.zeros_like(point_clouds)
    outlier_idx = np.zeros([num_pc, num_points], dtype=np.int16)
    outlier_num = np.zeros(num_pc, dtype=np.int16)
    inlier_pc = np.zeros_like(point_clouds)
    for l in range(num_pc):  # noqa: E741
        dists = knn_dists[l]

        out_idx = np.where(dists > knn_dist_thresh)[0]
        n_out = len(out_idx)
        out_points = point_clouds[l, out_idx, :]

        outlier_idx[l, :n_out] = out_idx
        outlier_num[l] = n_out
        outlier_pc[l, :n_out] = out_points
        if 0 < n_out < num_points:
            outlier_pc[l, n_out:] = out_points[-1]

        in_idx = np.where(dists <= knn_dist_thresh)[0]
        n_in = len(in_idx)
        in_points = point_clouds[l, in_idx, :]
        inlier_pc[l, :n_in, :] = in_points
        if 0 < n_in < num_points:
            inlier_pc[l, n_in:, :] = in_points[-1]

    return outlier_pc, outlier_idx, outlier_num, inlier_pc
