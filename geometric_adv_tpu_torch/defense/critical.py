"""Critical-points defense — a copy of ``geometric_adv_tpu/defense/
critical.py``, pinned to it by ``tests/test_torch_defense.py``.

A point is *critical* if it attains the per-channel maximum of the encoder's
pre-symmetry feature map — the max-pool bottleneck "sees" only these points.
The defense removes the critical points (which carry the adversarial
perturbation's influence on the latent code) and re-encodes the remainder;
removed slots are padded by duplicating the last kept point, which cannot
change the latent code under max pooling
(reference: src/ae_utils.py:12-80, defender/run_defense_critical.py:180-208).

Host numpy: the ``np.unique`` + count-sort ordering ("most critical points
first", ties in the order np.unique emits — ascending index) is
parity-critical for the artifacts.
"""

from __future__ import annotations

import numpy as np


def get_critical_points(point_clouds, pre_symmetry_data=None, *,
                        max_idx_all=None, max_val_all=None):
    """Per-cloud critical points, sorted by how many channels they win.

    reference: src/ae_utils.py:12-48 (minus the save-to-disk plumbing).

    Accepts either the full pre-symmetry feature map [N, n, bneck] or the
    precomputed per-channel (argmax, max) pair [N, bneck] — the latter is
    what the CLI ships from device (the full map is n times larger and
    dominated the defense stage's host transfer).

    Returns (critical_points [N, bneck, 3] zero-padded,
             idx_critical [N, bneck] int16 zero-padded,
             num_critical [N] int16).
    """
    if max_idx_all is None:
        max_val_all = np.max(pre_symmetry_data, axis=1)
        max_idx_all = np.argmax(pre_symmetry_data, axis=1)
    num_pc, bottleneck_size = max_idx_all.shape
    critical_points = np.zeros(
        [num_pc, bottleneck_size, 3], dtype=point_clouds.dtype
    )
    idx_critical = np.zeros([num_pc, bottleneck_size], dtype=np.int16)
    num_critical = np.zeros(num_pc, dtype=np.int16)
    for i in range(num_pc):
        max_val = max_val_all[i]
        max_idx = max_idx_all[i]
        # drop channels whose entire column is <= 0 (dead ReLU channels)
        max_idx_non_zero = max_idx[max_val > 0.0]
        idx_critical_pc, counts = np.unique(
            max_idx_non_zero, return_counts=True
        )
        n_crit = idx_critical_pc.shape[0]
        num_critical[i] = n_crit

        idx_sort = np.argsort(counts)[::-1]  # most critical points first
        idx_sorted = idx_critical_pc[idx_sort]
        critical_points[i, :n_crit, :] = point_clouds[i][idx_sorted]
        idx_critical[i, :n_crit] = idx_sorted
    return critical_points, idx_critical, num_critical


def _complementary_idx(idx, n):
    """reference: src/general_utils.py:84-91."""
    indicator = np.full(n, True)
    indicator[idx] = False
    return np.arange(n, dtype=int)[indicator]


def get_critical_pc_non_critical_pc(point_clouds, pre_symmetry_data=None, *,
                                    max_idx_all=None, max_val_all=None):
    """Split each cloud into critical / non-critical full-size clouds.

    Both outputs keep the input's [N, n, 3] shape by duplicating the last
    kept point (pooling-invariant padding).
    reference: src/ae_utils.py:51-80.
    """
    critical_points, critical_idx, critical_num = get_critical_points(
        point_clouds, pre_symmetry_data,
        max_idx_all=max_idx_all, max_val_all=max_val_all,
    )

    num_pc, n_points, _ = point_clouds.shape
    critical_pc = np.zeros_like(point_clouds)
    non_critical_pc = np.zeros_like(point_clouds)
    for k in range(num_pc):
        n_crit = int(critical_num[k])
        idx_pc = critical_idx[k, :n_crit]

        crit = point_clouds[k, idx_pc, :]
        critical_pc[k, :n_crit, :] = crit
        critical_pc[k, n_crit:, :] = crit[-1]

        comp_idx = _complementary_idx(idx_pc, n_points)
        non_crit = point_clouds[k, comp_idx, :]
        non_critical_pc[k, : len(non_crit)] = non_crit
        non_critical_pc[k, len(non_crit):] = non_crit[-1]

    return critical_points, critical_idx, critical_num, critical_pc, non_critical_pc
