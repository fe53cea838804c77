"""The geometric adversarial attack in plain PyTorch, float32 (Lang et al.,
3DV 2021, arXiv 2012.05657, section 3; the authors' src/adv_ae.py:191-251).

Per pair, a perturbation of the source starts from a truncated normal
(within 2 sigma, sigma 1e-7, drawn on the host from a generator seeded 55,
src/adversary.py:27-28) and takes ``iterations`` Adam steps on
``T-RE + w * S-CD`` with the victim frozen in inference mode: T-RE is the
chamfer distance of the adversarial input's reconstruction to the target
cloud, S-CD that of the adversarial input to the source. Adam is
TensorFlow's (the bias correction folded into the step size, epsilon
outside the square root). From iteration ``thresh`` on, each pair keeps the
iterate of the strictly smallest T-RE, with its metrics: loss_adv (T-RE),
loss_dist (S-CD), S-CD, T-NRE (T-RE over the victim's own reconstruction
error of the target) and T-RE.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference import pointnet_ae as ae
from h100_bench.reference.chamfer import chamfer_per_pc


def init_pert(shape, seed: int = 55, stddev: float = 1e-7) -> torch.Tensor:
    out = torch.empty(shape)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(seed))
    return out * stddev


def reconstruct(w, x, n_points: int):
    return ae.decode(w, ae.encode(w, x), n_points)


@torch.no_grad()
def metrics(w, adv, source, target, ref, n_points: int):
    """(the five metrics [B, 5], the reconstructions) of adversarial inputs."""
    recon = reconstruct(w, adv, n_points)
    t_re = chamfer_per_pc(recon, target)
    s_cd = chamfer_per_pc(adv, source)
    return torch.stack([t_re, s_cd, s_cd, t_re / ref, t_re], dim=-1), recon


@torch.no_grad()
def target_reference_error(w, target, n_points: int):
    """The victim's own reconstruction error of each target (T-NRE's base)."""
    return chamfer_per_pc(reconstruct(w, target, n_points), target)


def attack(w, source, target, ref, pert0, n_points: int, iterations: int,
           thresh: int, lr: float, dist_weight: float, record=()):
    """-> (metrics [B, 5], adversarial inputs [B, n, 3]) of the kept iterates,
    and {t: the adversarial inputs after t steps} for each t in ``record``."""
    pert = pert0.clone()
    m = torch.zeros_like(pert)
    v = torch.zeros_like(pert)
    rows = source.shape[0]
    best_key = torch.full((rows,), 1e10, device=source.device)
    best_metrics = torch.zeros((rows, 5), device=source.device)
    best_adv = torch.zeros_like(source)
    b1, b2, eps = 0.9, 0.999, 1e-8
    seen = {}
    for t in range(iterations + 1):
        last = t == iterations
        pert.requires_grad_(not last)
        with torch.set_grad_enabled(not last):
            adv = source + pert
            if t in record:
                seen[t] = adv.detach().clone()
            recon = reconstruct(w, adv, n_points)
            t_re = chamfer_per_pc(recon, target)
            s_cd = chamfer_per_pc(adv, source)
            total = (t_re + dist_weight * s_cd).sum()
            grad = None if last else torch.autograd.grad(total, pert)[0]
        with torch.no_grad():
            if t >= max(thresh, 1):
                better = t_re < best_key
                best_key = torch.where(better, t_re, best_key)
                row = torch.stack([t_re, s_cd, s_cd, t_re / ref, t_re], dim=-1)
                best_metrics = torch.where(better[:, None], row, best_metrics)
                best_adv = torch.where(better[:, None, None], adv, best_adv)
            if not last:
                m = b1 * m + (1 - b1) * grad
                v = b2 * v + (1 - b2) * grad * grad
                k = np.float32(t + 1)
                lr_t = float(np.float32(lr) * np.sqrt(np.float32(1) - np.float32(b2) ** k)
                             / (np.float32(1) - np.float32(b1) ** k))
                pert = pert.detach() - lr_t * m / (torch.sqrt(v) + eps)
    return best_metrics, best_adv, seen
