"""Metro (mesh-to-mesh Hausdorff) evaluation of AtlasNet
(``geometric_adv_tpu/transfer/metro.py``; reference:
transfer/atlasnet/training/trainer_loss.py:60-101, training/metro.py:14-32,
which shell out to the external ``metro`` binary).

Both surfaces are sampled with area-weighted barycentric points from an
explicit ``torch.Generator`` and the symmetric Hausdorff distance of the two
sample sets is taken: on the card through K2 (``nn_distance_values``: one
launch for both directions, as the JAX package's TPU route), on the CPU
through K2's plain version in row chunks, which bounds the live distance
plane at [chunk, m] instead of the full [n, m] (3.6 GB at the 30k default).
With ``n_samples`` samples a side, the sampled distance approximates the
surface Hausdorff to O(sqrt(area / n_samples)) (PARITY.md's metro entry).
"""

from __future__ import annotations

import numpy as np
import torch

from geometric_adv_tpu_torch.ops.chamfer import (
    _on_cuda,
    nn_distance_values,
    nn_distance_values_plain,
)

# rows of the first cloud per chunk of the CPU route: a [1024, 30000] plane
_HOST_CHUNK = 1024


def nn_distance_values_chunked(xyz1: torch.Tensor, xyz2: torch.Tensor,
                               chunk: int = _HOST_CHUNK):
    """K2's plain version over row chunks of ``xyz1`` ([..., n, 3] x
    [..., m, 3] -> ([..., n], [..., m])): each chunk's plane at a time, the
    column minima merged across chunks. A minimum is exact in any order, so
    this equals ``nn_distance_values_plain`` bit for bit."""
    d1, d2 = [], None
    for s in range(0, xyz1.shape[-2], chunk):
        a, b = nn_distance_values_plain(xyz1[..., s:s + chunk, :], xyz2)
        d1.append(a)
        d2 = b if d2 is None else torch.minimum(d2, b)
    return torch.cat(d1, dim=-1), d2


def square_grid_faces(grain: int) -> np.ndarray:
    """Triangle faces for the ``square_template_points`` grid: vertex (i, j)
    at ``i * grain + j``, two triangles per cell (reference:
    transfer/atlasnet/model/template.py:91-117)."""
    faces = []
    for i in range(grain - 1):
        for j in range(grain - 1):
            a = i * grain + j
            b = (i + 1) * grain + j
            c = i * grain + j + 1
            d = (i + 1) * grain + j + 1
            faces.append([a, b, c])
            faces.append([b, d, c])
    return np.asarray(faces, np.int32)


def merge_patch_meshes(patch_points: np.ndarray, patch_faces: np.ndarray):
    """[P, V, 3] patch vertices + shared per-patch faces -> one mesh
    (reference: ``pymesh.merge_meshes``, transfer/atlasnet/model/
    atlasnet.py:82-87): vertices concatenated, each patch's faces offset by
    its vertex base."""
    p, v, _ = patch_points.shape
    verts = patch_points.reshape(p * v, 3)
    faces = np.concatenate(
        [patch_faces + i * v for i in range(p)], axis=0
    ).astype(np.int32)
    return verts, faces


def sample_mesh_surface(vertices, faces, n_samples: int,
                        generator: torch.Generator, device) -> torch.Tensor:
    """[n_samples, 3] area-weighted barycentric surface samples on
    ``device``; zero-area triangles are never drawn."""
    verts = torch.as_tensor(np.asarray(vertices, np.float32), device=device)
    f = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    areas = 0.5 * torch.linalg.norm(torch.linalg.cross(v1 - v0, v2 - v0), dim=-1)
    tri = torch.multinomial(areas, n_samples, replacement=True, generator=generator)
    uv = torch.rand((n_samples, 2), generator=generator, device=device)
    # fold the unit square onto the triangle (u + v <= 1)
    uv = torch.where((uv.sum(dim=-1) > 1.0)[:, None], 1.0 - uv, uv)
    a, b, c = v0[tri], v1[tri], v2[tri]
    return a + uv[:, :1] * (b - a) + uv[:, 1:2] * (c - a)


def hausdorff_sampled(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Symmetric Hausdorff distance (true L2) of two [n, 3] sample sets."""
    if _on_cuda(s1):
        d1, d2 = nn_distance_values(s1[None], s2[None])
    else:
        d1, d2 = nn_distance_values_chunked(s1, s2)
    return torch.sqrt(torch.maximum(d1.max(), d2.max()))


def metro_distance(vertices1, faces1, vertices2, faces2, n_samples: int = 30_000,
                   seed: int = 0, device="cuda") -> float:
    """Sampled symmetric Hausdorff distance between two triangle meshes, the
    port of ``metro.metro(path1, path2)`` (reference:
    transfer/atlasnet/training/metro.py:14-32); both sides' samples from one
    generator seeded with ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s1 = sample_mesh_surface(vertices1, faces1, n_samples, gen, device)
    s2 = sample_mesh_surface(vertices2, faces2, n_samples, gen, device)
    return float(hausdorff_sampled(s1, s2))


@torch.no_grad()
def atlasnet_generate_mesh(trainer, cloud):
    """The merged patch mesh of ONE input cloud (reference:
    transfer/atlasnet/model/atlasnet.py:71-89): encode, deform each SQUARE
    patch's regular grid, carry the grid's triangulation, merge. -> (vertices
    [P*G*G, 3], faces [F, 3]) as numpy."""
    model = trainer.model
    if model.template_type != "SQUARE":
        raise ValueError(
            "mesh generation needs the SQUARE template (the grid carries the "
            f"triangulation); model uses {model.template_type!r}")
    g = int(np.sqrt(model.pts_per_primitive))
    if g * g != model.pts_per_primitive:
        raise ValueError(f"pts_per_primitive={model.pts_per_primitive} is not a "
                         "square grid; cannot triangulate")
    x = torch.as_tensor(np.asarray(cloud, np.float32)[None], device=trainer.device)
    trainer.model.eval()
    recon = trainer._forward_eval(x)[0].cpu().numpy()
    patch_pts = recon.reshape(model.nb_primitives, model.pts_per_primitive, 3)
    return merge_patch_meshes(patch_pts, square_grid_faces(g))


def metro_eval(trainer, clouds, gt_meshes, n_samples: int = 30_000, seed: int = 0):
    """Mean metro distance of AtlasNet's meshes against ground-truth meshes
    (reference: transfer/atlasnet/training/trainer_loss.py:62-101), the
    samples on the trainer's device. -> (mean, per-pair distances)."""
    results = []
    for i, (cloud, (gv, gf)) in enumerate(zip(clouds, gt_meshes)):
        mv, mf = atlasnet_generate_mesh(trainer, cloud)
        results.append(metro_distance(mv, mf, gv, gf, n_samples=n_samples,
                                      seed=seed + i, device=trainer.device))
    return float(np.mean(results)), results
