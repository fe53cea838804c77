"""The one generator of the benchmark's inputs: seeded synthetic point clouds
on the device, and pairs of them for the attack.

Every cloud is one of a few surfaces (sphere, cube, torus, cone, cylinder),
sampled uniformly in its own parameters, stretched along each axis, turned
about the vertical axis and scaled into the unit ball, as the paper's
ShapeNet clouds are. The draws come from one ``torch.Generator`` on the
device seeded with the run's seed, in a few large calls, so the same seed
gives the same clouds and any seed gives the same sizes.
"""

from __future__ import annotations

import math

import torch

KINDS = ("sphere", "cube", "torus", "cone", "cylinder")


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device``; any whole number is a seed (taken mod 2^63)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _surfaces(u: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
    """[len(KINDS), c, p, 3]: every kind's point for each (u, v) draw."""
    a = 2 * math.pi * u[..., 0]
    v = u[..., 1]
    # sphere: uniform by z = 1 - 2v
    z = 1 - 2 * v
    r = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
    sphere = torch.stack([r * torch.cos(a), r * torch.sin(a), z], dim=-1)
    # cube surface: a face, then two free coordinates in [-1, 1]
    s, t = 2 * u[..., 0] - 1, 2 * v - 1
    axis, sign = face % 3, (face // 3).float() * 2 - 1
    cube = torch.stack([
        torch.where(axis == 0, sign, s),
        torch.where(axis == 1, sign, torch.where(axis == 0, s, t)),
        torch.where(axis == 2, sign, t),
    ], dim=-1)
    # torus: major radius 0.7, minor 0.3
    b = 2 * math.pi * v
    ring = 0.7 + 0.3 * torch.cos(b)
    torus = torch.stack([ring * torch.cos(a), ring * torch.sin(a), 0.3 * torch.sin(b)], dim=-1)
    # cone: apex up, radius shrinking with height (area-uniform in sqrt(v))
    h = torch.sqrt(v)
    cone = torch.stack([h * torch.cos(a), h * torch.sin(a), 1 - 2 * h], dim=-1)
    cylinder = torch.stack([torch.cos(a), torch.sin(a), 2 * v - 1], dim=-1)
    return torch.stack([sphere, cube, torus, cone, cylinder])


def make_clouds(gen: torch.Generator, count: int, points: int, device,
                kinds: int = len(KINDS)) -> tuple[torch.Tensor, torch.Tensor]:
    """(clouds [count, points, 3] float32, kind [count] int64) on ``device``."""
    kind = torch.randint(kinds, (count,), generator=gen, device=device)
    u = torch.rand((count, points, 2), generator=gen, device=device)
    face = torch.randint(6, (count, points), generator=gen, device=device)
    stretch = 0.5 + torch.rand((count, 1, 3), generator=gen, device=device)
    angle = 2 * math.pi * torch.rand((count, 1), generator=gen, device=device)
    pts = torch.gather(_surfaces(u, face), 0,
                       kind[None, :, None, None].expand(1, count, points, 3))[0]
    pts = pts * stretch
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = pts[..., 0], pts[..., 1]
    pts = torch.stack([c * x - s * y, s * x + c * y, pts[..., 2]], dim=-1)
    pts = pts - pts.mean(dim=1, keepdim=True)
    pts = pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]
    return pts.float().contiguous(), kind


def make_pairs(gen: torch.Generator, count: int, points: int, device):
    """(sources, targets) [count, points, 3]: each target of another kind
    than its source, as the attack's pair grid holds."""
    clouds, kind = make_clouds(gen, 2 * count, points, device)
    src, tgt = clouds[:count], clouds[count:]
    same = kind[:count] == kind[count:]
    # a target of the source's kind swaps with its neighbour's: the same
    # sizes for every seed, and almost every pair of two kinds
    tgt = torch.where(same[:, None, None], tgt.roll(1, dims=0), tgt)
    return src.contiguous(), tgt.contiguous()
