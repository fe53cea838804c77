"""The adversarial attack, exact mode (``geometric_adv_tpu/attack/core.py``).

What the reference does (reference: src/adv_ae.py:191-251): per batch of
source/target pairs and per dist_weight, init a perturbation, run 500 Adam
steps on ``loss_adv + dist_weight * loss_dist`` wrt the perturbation only
(the victim AE is frozen), and from iteration 400 on keep the per-example
best output by target reconstruction error.

The port runs the JAX package's ``lax.scan`` as a Python loop over
t = 0..num_iterations on the device: step t records the post-update metrics
of reference iteration t (the forward that produces step t's gradient is
that iteration's metric read) and then takes the TF-exact Adam step. The
JAX ``vmap`` over dist weights becomes an explicit W axis folded into the
batch ([W*B, n, 3]); that is exact because the frozen AE acts on each
example alone. Every chamfer goes through ``ops.chamfer.nn_distance``, so on
the card the forward is kernel K1 and the gradient kernel K3; an EMD victim's
two losses go through ``ops.emd.emd_loss_fused`` (kernels K6 and K7).

Semantic parity notes:
- Adam replicates tf.train.AdamOptimizer (bias correction folded into lr_t,
  eps outside the sqrt; reference attack lr 0.01, attacker/run_attack.py:28);
- best-update is strict ``<`` on the target reconstruction error from iteration
  ``num_iterations_thresh`` on (reference: src/adv_ae.py:234-246);
- pert init: truncated normal within +/-2 sigma, stddev 1e-7, seed 55
  (reference: src/adversary.py:27-28), drawn from a ``torch.Generator``;
  its numbers differ from jax.random's, so ``attack_batch`` takes an
  injected ``pert0`` for parity tests;
- BN runs in inference mode with frozen moving stats.

Not ported, with reasons: the TPU routing (``_calibrate_chamfer_impl``,
``BATCH_THE_TWO_CHAMFERS``, the fused-loss kernel K5 and the sparse encoder
VJP) — the port takes the composed path; ``chamfer_refresh > 0`` (ROADMAP
Queue 1 item 9), meshes (item 17) and ``binary_search_attack``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc, nn_distance
from geometric_adv_tpu_torch.ops.emd import emd_loss_fused

# Pairs per attack call when the caller gives none: 1,024,000 point rows
# (500 pairs at 2048 points), the JAX package's default dispatch size.
# Autograd keeps the encoder's activations of every row; the peak device
# memory at this size is not measured yet.
MAX_POINT_ROWS = 1_024_000


class AttackOutputs(NamedTuple):
    """Mirrors the reference's per-class attack artifacts
    (reference: attacker/run_attack.py:141-144, src/adv_ae.py:249)."""

    metrics: np.ndarray  # [W, B, 5]: loss_adv, loss_dist, S-CD, T-NRE, T-RE
    pc_input: np.ndarray  # [W, B, n, 3] adversarial inputs
    pc_recon: np.ndarray  # [W, B, m, 3] their reconstructions


def pert_losses(pert: torch.Tensor):
    """(L2 norm of the full perturbation, max per-point norm) per example
    (reference: src/adversary.py:39-57)."""
    per_point_sq = (pert * pert).sum(dim=-1)
    return per_point_sq.sum(dim=-1).sqrt(), per_point_sq.amax(dim=-1).sqrt()


def _tf_adam_update(g, m, v, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """tf.train.AdamOptimizer's exact update rule; lr_t in float32 as the
    JAX package computes it."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    tf = np.float32(t)
    lr_t = np.float32(lr) * np.sqrt(np.float32(1.0) - np.float32(b2) ** tf) / (
        np.float32(1.0) - np.float32(b1) ** tf
    )
    step = float(lr_t) * m / (torch.sqrt(v) + eps)
    return step, m, v


def init_pert(shape, device, stddev=1e-7, seed=55) -> torch.Tensor:
    """Truncated normal within +/-2 sigma (reference: src/adversary.py:27-28),
    drawn on the CPU from a generator seeded ``seed``."""
    out = torch.empty(shape)
    torch.nn.init.trunc_normal_(
        out, 0.0, 1.0, -2.0, 2.0, generator=torch.Generator().manual_seed(seed)
    )
    return (out * stddev).to(device)


def _check_loss_types(ae_loss_type, loss_adv_type, loss_dist_type):
    if ae_loss_type not in ("chamfer", "emd"):
        raise ValueError(f"unknown ae loss {ae_loss_type!r}")
    if loss_adv_type not in ("chamfer", "latent"):
        raise ValueError(f"unknown loss_adv_type {loss_adv_type!r}")
    if loss_dist_type not in ("chamfer", "pert"):
        raise ValueError(f"unknown loss_dist_type {loss_dist_type!r}")


def make_attack_loss(
    encode: Callable[[torch.Tensor], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
    loss_adv_type: str,
    loss_dist_type: str,
    ae_loss_type: str,
    max_point_pert_weight: float,
    max_point_dist_weight: float,
):
    """Build the attack's (total_loss, aux) function of the perturbation
    (reference: src/adv_ae.py:78-142)."""
    _check_loss_types(ae_loss_type, loss_adv_type, loss_dist_type)

    def forward(pert, x, target_z, gt, dist_weight):
        adv = x + pert
        z = encode(adv)
        recon = decode(z)
        if ae_loss_type == "emd":
            t_re = emd_loss_fused(recon, gt)
            # the reference's EMD branch is dead code (src/adv_ae.py:129-142,
            # SURVEY section 2.2); the JAX package's repaired semantics use
            # the per-example EMD cost for the distance and its max proxy
            input_dist_per_pc = emd_loss_fused(adv, x)
            max_dist_per_pc = input_dist_per_pc
        elif max_point_dist_weight == 0.0:
            t_re = chamfer_loss_per_pc(recon, gt)
            input_dist_per_pc = chamfer_loss_per_pc(adv, x)
            max_dist_per_pc = input_dist_per_pc  # unused (weight 0)
        else:
            t_re = chamfer_loss_per_pc(recon, gt)
            # the max-point term needs the per-point d1 vector
            d1, _, d2, _ = nn_distance(adv, x)
            input_dist_per_pc = d1.mean(dim=-1) + d2.mean(dim=-1)
            max_dist_per_pc = d1.amax(dim=-1)

        loss_pert, loss_max = pert_losses(pert)
        if loss_adv_type == "latent":
            diff = z - target_z
            loss_adv = (diff * diff).sum(dim=-1).sqrt()
        else:
            loss_adv = t_re
        if loss_dist_type == "pert":
            loss_dist = loss_pert
            if max_point_pert_weight > 0.0:
                loss_dist = loss_dist + max_point_pert_weight * loss_max
        else:
            loss_dist = input_dist_per_pc
            if max_point_dist_weight > 0.0:
                loss_dist = loss_dist + max_point_dist_weight * max_dist_per_pc

        total = (loss_adv + dist_weight * loss_dist).sum()
        aux = {
            "loss_adv": loss_adv,
            "loss_dist": loss_dist,
            "source_chamfer": input_dist_per_pc,
            "t_re": t_re,
            "adv": adv,
            "recon": recon,
        }
        return total, aux

    return forward


def attack_batch(
    encode: Callable[[torch.Tensor], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
    source_pc: torch.Tensor,  # [B, n, 3]
    target_latent: torch.Tensor,  # [B, z]
    target_pc: torch.Tensor,  # [B, m, 3]
    target_ae_loss_ref: torch.Tensor,  # [B]
    dist_weights,  # [W]
    *,
    num_iterations: int = 500,
    num_iterations_thresh: int = 400,
    learning_rate: float = 0.01,
    loss_adv_type: str = "chamfer",
    loss_dist_type: str = "chamfer",
    ae_loss_type: str = "chamfer",
    max_point_pert_weight: float = 0.0,
    max_point_dist_weight: float = 0.0,
    pert0: torch.Tensor | None = None,
) -> AttackOutputs:
    """Run the full attack for one batch of pairs, all dist weights at once.

    All tensors live on one device. ``pert0`` ([B, n, 3]) replaces the
    seeded init, the same for every weight as in the JAX package. Returns
    numpy outputs of shapes [W, B, 5], [W, B, n, 3], [W, B, m, 3].
    """
    forward = make_attack_loss(
        encode, decode, loss_adv_type, loss_dist_type, ae_loss_type,
        max_point_pert_weight, max_point_dist_weight,
    )
    device = source_pc.device
    weights = torch.as_tensor(
        np.asarray(dist_weights, np.float32), device=device
    )
    if weights.dim() != 1:
        raise NotImplementedError(
            "per-example dist weights (the binary-search variant) are not "
            "ported yet"
        )
    w_count, (b, n, _) = weights.shape[0], source_pc.shape
    m = target_pc.shape[1]

    def fold(t):  # [B, ...] -> [W*B, ...], weight-major like the vmap
        return t.repeat((w_count,) + (1,) * (t.dim() - 1))

    x, tz, gt, ref = (fold(t) for t in (
        source_pc, target_latent, target_pc, target_ae_loss_ref))
    dist_weight = weights.repeat_interleave(b)
    if pert0 is None:
        pert0 = init_pert((b, n, 3), device)
    pert = fold(pert0.to(device=device, dtype=torch.float32))
    m_acc = torch.zeros_like(pert)
    v_acc = torch.zeros_like(pert)
    rows = w_count * b
    best_key = torch.full((rows,), 1e10, device=device)
    best_metrics = torch.zeros((rows, 4), device=device)
    best_adv = torch.zeros((rows, n, 3), device=device)
    best_recon = torch.zeros((rows, m, 3), device=device)
    thresh = max(num_iterations_thresh, 1)

    # steps t = 0..num_iterations: step t records the state after t Adam
    # updates (t = 0 is never recorded since thresh >= 1)
    for t in range(num_iterations + 1):
        last = t == num_iterations
        pert.requires_grad_(not last)
        with torch.set_grad_enabled(not last):
            total, aux = forward(pert, x, tz, gt, dist_weight)
            grads = None if last else torch.autograd.grad(total, pert)[0]
        with torch.no_grad():
            if t >= thresh:
                better = aux["t_re"] < best_key  # strict <
                best_key = torch.where(better, aux["t_re"], best_key)
                metrics = torch.stack(
                    [aux["loss_adv"], aux["loss_dist"], aux["source_chamfer"],
                     aux["t_re"] / ref], dim=-1,
                )
                best_metrics = torch.where(better[:, None], metrics, best_metrics)
                best_adv = torch.where(better[:, None, None], aux["adv"], best_adv)
                best_recon = torch.where(
                    better[:, None, None], aux["recon"], best_recon
                )
            if not last:
                step, m_acc, v_acc = _tf_adam_update(
                    grads, m_acc, v_acc, t + 1, learning_rate
                )
                pert = pert.detach() - step

    metrics = torch.cat([best_metrics, best_key[:, None]], dim=-1)
    return AttackOutputs(
        metrics.reshape(w_count, b, 5).cpu().numpy(),
        best_adv.reshape(w_count, b, n, 3).cpu().numpy(),
        best_recon.reshape(w_count, b, m, 3).cpu().numpy(),
    )


class AttackRunner:
    """Host-side runner: frozen victim AE + the attack loop on ``device``
    (replaces ``AdvAE`` + ``Adversary``, reference: src/adv_ae.py:25-304)."""

    def __init__(self, model, conf, device):
        if int(getattr(conf, "chamfer_refresh", 0) or 0):
            raise NotImplementedError(
                "chamfer_refresh > 0 (the frozen-assignment mode) is not "
                "ported yet (ROADMAP Queue 1 item 9)"
            )
        _check_loss_types(conf.loss, conf.loss_adv_type, conf.loss_dist_type)
        self.model = model.eval().requires_grad_(False)
        self.conf = conf
        self.device = torch.device(device)

    def attack(self, source_pc, target_latent, target_pc, target_ae_loss_ref,
               batch_size: int | None = None, log_file=None,
               pert0: np.ndarray | None = None) -> AttackOutputs:
        """Attack a grid of pairs; returns numpy (metrics [W,N,5],
        adv [W,N,n,3], recon [W,N,m,3]) (reference: src/adv_ae.py:155-189).
        ``batch_size`` pairs go to each call (default: MAX_POINT_ROWS point
        rows); ``pert0`` ([N, n, 3]) replaces the seeded init."""
        conf = self.conf
        n_examples = len(source_pc)
        batch_size = batch_size or min(
            max(1, MAX_POINT_ROWS // source_pc.shape[-2]), n_examples
        )
        dist_weights = np.asarray(conf.dist_weight_list, np.float32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        outs = []
        for s in range(0, n_examples, batch_size):
            t0 = time.time()
            sl = slice(s, min(s + batch_size, n_examples))
            outs.append(attack_batch(
                self.model.encode, self.model.decode,
                dev(source_pc[sl]), dev(target_latent[sl]), dev(target_pc[sl]),
                dev(target_ae_loss_ref[sl]), dist_weights,
                num_iterations=conf.num_iterations,
                num_iterations_thresh=conf.num_iterations_thresh,
                learning_rate=conf.learning_rate,
                loss_adv_type=conf.loss_adv_type,
                loss_dist_type=conf.loss_dist_type,
                ae_loss_type=conf.loss,
                max_point_pert_weight=conf.max_point_pert_weight,
                max_point_dist_weight=conf.max_point_dist_weight,
                pert0=None if pert0 is None else dev(pert0[sl]),
            ))
            dur = time.time() - t0
            count = sl.stop - sl.start
            msg = (
                f"Attack pairs {s}-{sl.stop} of {n_examples}: {dur:.2f}s "
                f"({conf.num_iterations * count * len(dist_weights) / dur:.0f} "
                "iter/s)"
            )
            print(msg)
            if log_file is not None:
                log_file.write(msg + "\n")

        return AttackOutputs(
            np.concatenate([o.metrics for o in outs], axis=1),
            np.concatenate([o.pc_input for o in outs], axis=1),
            np.concatenate([o.pc_recon for o in outs], axis=1),
        )
