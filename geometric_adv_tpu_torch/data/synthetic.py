"""Synthetic point-cloud dataset — the sampler of
``geometric_adv_tpu/data/synthetic.py`` (same shapes, same random streams,
pinned by ``tests/test_torch_imports.py``). Each class is a parametric
surface sampled at ``n_points`` with per-instance shape jitter, normalised
into the unit sphere; ``make_shapenet_like_dir`` writes the
/class_name/model_XXXX.ply tree the loaders read. The analytic meshes of the
metro leg are not copied.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.data.datasets import create_dir
from geometric_adv_tpu_torch.data.ply import save_ply

SHAPE_CLASSES = (
    "sphere", "cube", "cylinder", "torus", "cone", "pyramid", "plane_xy",
    "helix", "saddle", "ellipsoid", "cross", "tube", "disk",
)


def _normalise_params(pc: np.ndarray) -> tuple[np.ndarray, float]:
    """(center, scale) that _unit_normalise applies: pc' = (pc - center)*scale."""
    center = (pc.max(axis=0) + pc.min(axis=0)) / 2
    radius = np.linalg.norm(pc - center, axis=1).max()
    return center, 0.5 / max(radius, 1e-9)


def _unit_normalise(pc: np.ndarray) -> np.ndarray:
    center, scale = _normalise_params(pc)
    return (pc - center) * scale


def _sample_raw(
    name: str, n_points: int, rng: np.random.RandomState
) -> tuple[np.ndarray, tuple[float, float, float]]:
    u = rng.rand(n_points) * 2 * np.pi
    v = rng.rand(n_points) * np.pi
    t = rng.rand(n_points)
    # per-instance jitter so instances within a class differ
    a = 0.7 + 0.6 * rng.rand()
    b = 0.7 + 0.6 * rng.rand()
    c = 0.7 + 0.6 * rng.rand()

    if name == "sphere":
        pc = np.stack(
            [a * np.sin(v) * np.cos(u), b * np.sin(v) * np.sin(u),
             c * np.cos(v)], 1)
    elif name == "ellipsoid":
        pc = np.stack(
            [1.5 * a * np.sin(v) * np.cos(u), 0.6 * b * np.sin(v) * np.sin(u),
             0.9 * c * np.cos(v)], 1)
    elif name == "cube":
        face = rng.randint(0, 6, n_points)
        xy = rng.rand(n_points, 2) * 2 - 1
        pc = np.zeros((n_points, 3))
        for f in range(6):
            m = face == f
            fixed = np.full(m.sum(), 1.0 if f % 2 == 0 else -1.0)
            cols = [i for i in range(3) if i != f // 2]
            pc[m, f // 2] = fixed
            pc[m, cols[0]] = xy[m, 0]
            pc[m, cols[1]] = xy[m, 1]
        pc *= np.array([a, b, c])
    elif name == "cylinder":
        pc = np.stack(
            [a * np.cos(u), b * np.sin(u), c * (2 * t - 1) * 1.4], 1)
    elif name == "tube":
        pc = np.stack(
            [0.4 * a * np.cos(u), 0.4 * b * np.sin(u), c * (2 * t - 1) * 2.0],
            1)
    elif name == "torus":
        r_small = 0.25 * c
        pc = np.stack(
            [(a + r_small * np.cos(v * 2)) * np.cos(u),
             (b + r_small * np.cos(v * 2)) * np.sin(u),
             r_small * np.sin(v * 2)], 1)
    elif name == "cone":
        pc = np.stack(
            [a * t * np.cos(u), b * t * np.sin(u), c * (1 - t) * 1.5], 1)
    elif name == "pyramid":
        s = 1 - t
        sq = (rng.rand(n_points, 2) * 2 - 1) * s[:, None]
        pc = np.stack([a * sq[:, 0], b * sq[:, 1], c * t * 1.5], 1)
    elif name == "plane_xy":
        sq = rng.rand(n_points, 2) * 2 - 1
        pc = np.stack(
            [1.4 * a * sq[:, 0], b * sq[:, 1],
             0.05 * c * rng.randn(n_points)], 1)
    elif name == "helix":
        w = t * 4 * np.pi
        pc = np.stack(
            [a * np.cos(w), b * np.sin(w), c * (2 * t - 1) * 1.5], 1)
        pc += 0.08 * rng.randn(n_points, 3)
    elif name == "saddle":
        sq = rng.rand(n_points, 2) * 2 - 1
        pc = np.stack(
            [a * sq[:, 0], b * sq[:, 1],
             0.7 * c * (sq[:, 0] ** 2 - sq[:, 1] ** 2)], 1)
    elif name == "cross":
        arm = rng.randint(0, 3, n_points)
        pc = 0.15 * rng.randn(n_points, 3)
        for ax in range(3):
            m = arm == ax
            pc[m, ax] = (2 * t[m] - 1) * 1.4
        pc *= np.array([a, b, c])
    elif name == "disk":
        r = np.sqrt(t)
        pc = np.stack(
            [a * r * np.cos(u), b * r * np.sin(u),
             0.05 * c * rng.randn(n_points)], 1)
    else:
        raise ValueError(f"unknown synthetic class {name!r}")
    return pc, (a, b, c)


def sample_shape(
    name: str, n_points: int, rng: np.random.RandomState
) -> np.ndarray:
    pc, _ = _sample_raw(name, n_points, rng)
    return _unit_normalise(pc).astype(np.float32)


def make_shapenet_like_dir(
    out_dir, class_names=SHAPE_CLASSES, n_per_class=40, n_points=1024, seed=0
) -> str:
    """Materialise a /class_name/model_XXX.ply tree for CLI smoke runs."""
    rng = np.random.RandomState(seed)
    for name in class_names:
        class_dir = create_dir(osp.join(out_dir, name))
        for i in range(n_per_class):
            save_ply(
                osp.join(class_dir, f"model_{i:04d}.ply"),
                sample_shape(name, n_points, rng),
            )
    return out_dir
