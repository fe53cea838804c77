"""Augmentations and canonical-axes preprocessing.

Copied from ``geometric_adv_tpu/data/augment.py`` and pinned to it by
``tests/test_torch_imports.py``: ``sort_axes`` (reference:
src/shift_rotate_util.py:22-62), ``rand_rotation_matrix`` and
``apply_augmentations`` (reference: src/general_utils.py:16-61, 124-144),
host-side numpy.

``device_augment`` is the training loop's counterpart on tensors: the same
distributions -- N(mu, sigma) jitter per element and one uniform z-rotation
per batch -- drawn from a ``torch.Generator`` on the batch's device, so its
numbers are not the JAX package's (``jax.random``) nor numpy's.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


def rand_rotation_matrix(deflection=1.0, z_only=True, seed=None) -> np.ndarray:
    """reference: src/general_utils.py:16-61."""
    if seed is not None:
        np.random.seed(seed)
    theta, phi, z = np.random.uniform(size=(3,))
    theta = theta * 2.0 * deflection * np.pi
    phi = phi * 2.0 * np.pi
    z = z * 2.0 * deflection

    st, ct = np.sin(theta), np.cos(theta)
    r = np.array(((ct, st, 0), (-st, ct, 0), (0, 0, 1)))
    if not z_only:
        rt = np.sqrt(z)
        v = (np.sin(phi) * rt, np.cos(phi) * rt, np.sqrt(2.0 - z))
        return (np.outer(v, v) - np.eye(3)).dot(r)
    return r


def apply_augmentations(batch: np.ndarray, conf) -> np.ndarray:
    """reference: src/general_utils.py:124-144."""
    if conf.gauss_augment is not None or conf.z_rotate:
        batch = batch.copy()

    if conf.gauss_augment is not None:
        mu = conf.gauss_augment["mu"]
        sigma = conf.gauss_augment["sigma"]
        batch += np.random.normal(mu, sigma, batch.shape)

    if conf.z_rotate:
        r_rotation = rand_rotation_matrix()
        r_rotation[0, 2] = 0
        r_rotation[2, 0] = 0
        r_rotation[1, 2] = 0
        r_rotation[2, 1] = 0
        r_rotation[2, 2] = 1
        batch = batch.dot(r_rotation)
    return batch


def device_augment(batch: torch.Tensor, generator: torch.Generator,
                   gauss_mu: float | None = None,
                   gauss_sigma: float | None = None,
                   z_rotate: bool = False) -> torch.Tensor:
    """Gaussian jitter per element, then ONE z-rotation for the whole batch,
    ``batch @ [[c, s, 0], [-s, c, 0], [0, 0, 1]]`` with theta ~ U[0, 2 pi)
    (reference: src/general_utils.py:124-144; the JAX package's
    ``device_augment``). ``generator`` lives on the batch's device."""
    if gauss_sigma is not None:
        mu = 0.0 if gauss_mu is None else gauss_mu
        noise = torch.randn(batch.shape, generator=generator, dtype=batch.dtype,
                            device=batch.device)
        batch = batch + (mu + gauss_sigma * noise)
    if z_rotate:
        theta = torch.rand((), generator=generator, dtype=batch.dtype,
                           device=batch.device) * (2.0 * math.pi)
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([torch.stack([c, s, zero]),
                           torch.stack([-s, c, zero]),
                           torch.stack([zero, zero, one])])
        batch = batch @ rot
    return batch


def euler2mat(rotation: np.ndarray, z_only: bool = True) -> np.ndarray:
    """Rotation matrix from (x, y, z) Euler angles
    (reference: src/shift_rotate_util.py:65-101)."""
    x, y, z = rotation
    cz, sz = np.cos(z), np.sin(z)
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    if z_only:
        m = mz
    else:
        cy, sy = np.cos(y), np.sin(y)
        my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        cx, sx = np.cos(x), np.sin(x)
        mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        m = mx @ my @ mz
    m = m.astype(np.float32)
    m[np.abs(m) < 1e-10] = 0.0
    return m
