"""Synthetic point-cloud dataset — the sampler of
``geometric_adv_tpu/data/synthetic.py`` (same shapes, same random streams,
pinned by ``tests/test_torch_imports.py``). Each class is a parametric
surface sampled at ``n_points`` with per-instance shape jitter, normalised
into the unit sphere; ``make_shapenet_like_dir`` writes the
/class_name/model_XXXX.ply tree the loaders read; ``sample_shape_and_mesh``
gives an instance's analytic mesh beside its cloud (the metro leg).
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


# ---------------------------------------------------------------------------
# analytic ground-truth meshes (for the metro eval leg)

# classes whose sampled point set lies ON a clean parametric surface that
# admits an exact triangle mesh with the same instance parameters. The
# noisy/volumetric classes (plane_xy, helix, cross, disk: gaussian
# thickness; pyramid: solid square cross-sections) are excluded — a surface
# mesh would NOT be the support of their samples.
MESHABLE_CLASSES = (
    "sphere", "ellipsoid", "cube", "cylinder", "tube", "torus", "cone",
    "saddle",
)


def _param_grid_faces(gu: int, gv: int, wrap_u=False, wrap_v=False):
    """Triangle faces over a gu x gv vertex grid (row-major i*gv+j),
    optionally wrapping either axis (closed parametric surfaces)."""
    faces = []
    for i in range(gu if wrap_u else gu - 1):
        i2 = (i + 1) % gu
        for j in range(gv if wrap_v else gv - 1):
            j2 = (j + 1) % gv
            va, vb = i * gv + j, i2 * gv + j
            vc, vd = i * gv + j2, i2 * gv + j2
            faces.append([va, vb, vc])
            faces.append([vb, vd, vc])
    return np.asarray(faces, np.int32)


def _uv_grid(gu, gv, ulo, uhi, vlo, vhi, endpoint_u, endpoint_v):
    u = np.linspace(ulo, uhi, gu, endpoint=endpoint_u)
    v = np.linspace(vlo, vhi, gv, endpoint=endpoint_v)
    return np.meshgrid(u, v, indexing="ij")


def shape_mesh_raw(name: str, a: float, b: float, c: float):
    """Exact triangle mesh of the parametric surface ``_sample_raw``
    samples, in RAW (pre-normalisation) coordinates, for the instance
    parameters (a, b, c). Returns (vertices [V, 3] f64, faces [F, 3] i32),
    or None for non-meshable classes (see MESHABLE_CLASSES)."""
    tau = 2 * np.pi
    if name in ("sphere", "ellipsoid"):
        u, v = _uv_grid(48, 25, 0, tau, 0, np.pi, False, True)
        sx, sy, sz = (
            (a, b, c) if name == "sphere" else (1.5 * a, 0.6 * b, 0.9 * c)
        )
        verts = np.stack(
            [sx * np.sin(v) * np.cos(u), sy * np.sin(v) * np.sin(u),
             sz * np.cos(v)], -1)
        faces = _param_grid_faces(48, 25, wrap_u=True)
    elif name == "cube":
        corners = np.array(
            [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
            np.float64,
        )
        verts = corners * np.array([a, b, c])
        # 12 triangles, 2 per face of the ±1 cube (corner index bit order:
        # x*4 + y*2 + z)
        faces = np.asarray(
            [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x = -1, +1
             [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y = -1, +1
             [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],  # z = -1, +1
            np.int32,
        )
        return verts, faces
    elif name in ("cylinder", "tube"):
        ra, rb, h = (
            (a, b, 1.4 * c) if name == "cylinder" else (0.4 * a, 0.4 * b, 2.0 * c)
        )
        u, t = _uv_grid(48, 9, 0, tau, -1, 1, False, True)
        verts = np.stack([ra * np.cos(u), rb * np.sin(u), h * t], -1)
        faces = _param_grid_faces(48, 9, wrap_u=True)
    elif name == "torus":
        r = 0.25 * c
        u, w = _uv_grid(48, 24, 0, tau, 0, tau, False, False)
        verts = np.stack(
            [(a + r * np.cos(w)) * np.cos(u),
             (b + r * np.cos(w)) * np.sin(u),
             r * np.sin(w)], -1)
        faces = _param_grid_faces(48, 24, wrap_u=True, wrap_v=True)
    elif name == "cone":
        u, t = _uv_grid(48, 9, 0, tau, 0, 1, False, True)
        verts = np.stack(
            [a * t * np.cos(u), b * t * np.sin(u), 1.5 * c * (1 - t)], -1)
        faces = _param_grid_faces(48, 9, wrap_u=True)
    elif name == "saddle":
        s0, s1 = _uv_grid(17, 17, -1, 1, -1, 1, True, True)
        verts = np.stack(
            [a * s0, b * s1, 0.7 * c * (s0 * s0 - s1 * s1)], -1)
        faces = _param_grid_faces(17, 17)
    else:
        return None
    return verts.reshape(-1, 3), faces


def sample_shape_and_mesh(
    name: str, n_points: int, rng: np.random.RandomState
):
    """(point cloud [n, 3] f32, (mesh_verts [V, 3] f32, faces) or None).

    The cloud is IDENTICAL to ``sample_shape`` for the same rng state (mesh
    construction consumes no rng draws), and the mesh is normalised with
    the cloud's own center/scale so both live in the same frame — the GT
    side of the metro eval (cli/run_metro.py)."""
    pc_raw, abc = _sample_raw(name, n_points, rng)
    center, scale = _normalise_params(pc_raw)
    pc = ((pc_raw - center) * scale).astype(np.float32)
    mesh = shape_mesh_raw(name, *abc)
    if mesh is None:
        return pc, None
    verts, faces = mesh
    return pc, (((verts - center) * scale).astype(np.float32), faces)


def make_dataset(
    class_names=SHAPE_CLASSES, n_per_class=40, n_points=2048, seed=0
):
    """Return (point_clouds [N, n, 3], slice_idx, labels, class_names)."""
    rng = np.random.RandomState(seed)
    pcs, slice_idx, labels = [], [0], []
    for ci, name in enumerate(class_names):
        for _ in range(n_per_class):
            pcs.append(sample_shape(name, n_points, rng))
        slice_idx.append(slice_idx[-1] + n_per_class)
        labels += [ci] * n_per_class
    return (
        np.stack(pcs),
        np.asarray(slice_idx),
        np.asarray(labels, dtype=np.int8),
        list(class_names),
    )


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
