"""Canonical-axes preprocessing — ``sort_axes`` copied from
``geometric_adv_tpu/data/augment.py`` (reference:
src/shift_rotate_util.py:22-62), pinned by ``tests/test_torch_imports.py``.
The augmentations themselves belong to AE training, which is not ported
yet.
"""

from __future__ import annotations

import numpy as np


def get_sort_axes_idx(point_clouds: np.ndarray):
    """reference: src/shift_rotate_util.py:47-62 (z axis untouched)."""
    assert point_clouds.ndim == 3
    max_val = point_clouds.max(axis=1)
    min_val = point_clouds.min(axis=1)
    axes_len = max_val - min_val

    axes_len_for_sort = axes_len.copy()
    axes_len_for_sort[:, 2] = 0.0
    axes_sort_idx = np.argsort(axes_len_for_sort, axis=1)[:, ::-1]
    assert np.all(axes_sort_idx[:, 2] == 2), "z axis must remain in place"
    return axes_sort_idx, axes_len


def sort_axes(point_clouds: np.ndarray, neg_rot: bool = True) -> np.ndarray:
    """Canonicalise xy axes per cloud (long axis -> x).

    reference: src/shift_rotate_util.py:22-44. NOTE: the reference mutates
    ``axes_len`` via ``get_sort_axes_idx`` aliasing before comparing
    ``axes_len[i,0] < axes_len[i,1]``; those columns are untouched by the
    aliasing (only z is zeroed), so a clean copy here is behaviour-identical.
    """
    axis_idx = int(neg_rot)
    axes_sort_idx, axes_len = get_sort_axes_idx(point_clouds)

    out = np.zeros_like(point_clouds)
    for i in range(len(point_clouds)):
        out[i] = point_clouds[i][:, axes_sort_idx[i]]
        if axes_len[i, 0] < axes_len[i, 1]:
            # x/y were swapped: mirror one axis so the permutation is a
            # proper rotation (det +1), not a reflection.
            out[i, :, axis_idx] = -out[i, :, axis_idx]

    _, axes_len_sorted = get_sort_axes_idx(out)
    assert np.all(axes_len_sorted[:, 0] >= axes_len_sorted[:, 1]), (
        "Wrong axes sorting: x length must be >= y length"
    )
    return out
