"""Training steps in plain PyTorch: the mean per-cloud chamfer loss of a
batch, its gradient with respect to every weight, and Adam (Kingma & Ba,
b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected)."""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_steps(weights: dict, names: list, batches: list, loss_fn, lr: float,
               moments: dict | None = None, taken: int = 0):
    """Take one Adam step per batch on the ``names`` leaves of ``weights``
    (a copy; the rest stay fixed), from Adam's ``moments`` ({name: (first,
    second)}) after ``taken`` steps, or from a fresh optimizer. -> (losses,
    the first step's gradients, the weights after the last step, the
    moments after it)."""
    w = {k: v.detach().clone() for k, v in weights.items()}
    if moments is None:
        moments = {k: (torch.zeros_like(w[k]), torch.zeros_like(w[k])) for k in names}
    m = {k: moments[k][0].clone() for k in names}
    v = {k: moments[k][1].clone() for k in names}
    losses, first = [], None
    for t, batch in enumerate(batches, start=taken + 1):
        for k in names:
            w[k].requires_grad_(True)
        loss = loss_fn(w, *batch)
        grads = torch.autograd.grad(loss, [w[k] for k in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            c1, c2 = 1 - B1 ** t, 1 - B2 ** t
            for k, g in zip(names, grads):
                m[k] = B1 * m[k] + (1 - B1) * g
                v[k] = B2 * v[k] + (1 - B2) * g * g
                w[k] = w[k].detach() - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + EPS)
    return losses, first, {k: w[k].detach() for k in names}, {k: (m[k], v[k]) for k in names}
