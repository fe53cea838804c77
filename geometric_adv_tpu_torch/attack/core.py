"""The adversarial attack (``geometric_adv_tpu/attack/core.py``).

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
example alone. An EMD victim's two losses go through ``ops.emd.
emd_loss_fused`` (kernels K6 and K7).

A chamfer victim's two chamfers route as in the JAX package:

- exact mode, ``chamfer_method`` "composed" (``nn_distance``: K1 forward,
  K3 backward), "fused" (K5 forward, elementwise backward) or "auto"
  (``ops.chamfer.chamfer_loss_per_pc``'s own routing). ``AttackRunner``
  binds the method: forced by ``chamfer_impl``, else measured on the card
  once per victim and shape (``_calibrate_chamfer_impl``);
- frozen-assignment mode, ``chamfer_refresh`` = N > 0 (PARITY.md #13): the
  loop runs in chunks of N steps; at each chunk's entry one payload pass per
  chamfer (K5 on the card at any n, without gradients) freezes the
  nearest-neighbour assignments, and in between the loss and its gradient
  are elementwise.

Semantic parity notes:
- Adam replicates tf.train.AdamOptimizer (bias correction folded into lr_t,
  eps outside the sqrt; reference attack lr 0.01, attacker/run_attack.py:28);
- best-update is strict ``<`` on the target reconstruction error from iteration
  ``num_iterations_thresh`` on (reference: src/adv_ae.py:234-246);
- pert init: truncated normal within +/-2 sigma, stddev 1e-7, seed 55
  (reference: src/adversary.py:27-28), drawn from a ``torch.Generator``;
  its numbers differ from jax.random's, so ``attack_batch`` takes an
  injected ``pert0`` for parity tests;
- BN runs in inference mode with frozen moving stats;
- frozen mode records the frozen (majorizing) chamfer values between
  refreshes, the JAX package's documented deviation (PARITY.md #13).

``binary_search_attack`` is the per-example dist-weight search (reference:
src/adv_ae.py:253-304) over ``attack_batch`` with [1, B] weights, tracked
by ``loss_dist``.

``AttackRunner`` differentiates the victim's encoder densely (autograd) or
through the argmax-sparse VJP (``models/sparse_encode.py``, ``encoder_vjp``),
and casts the victim's codes and reconstructions to float32, so a bfloat16
victim's losses and metrics stay float32, as in the JAX package.

``AttackRunner(mesh=)`` (``parallel/``) shards each call's pairs over the
processes of the mesh: each rank attacks its share of the call as a call of
its own (its perturbation drawn as one), and ``gather_global`` assembles
the call, so P ranks at a call of P * b pairs compute what one process
computes at calls of b.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from geometric_adv_tpu_torch.models import sparse_encode
from geometric_adv_tpu_torch.ops.chamfer import (
    _fused_loss_shape_ok,
    chamfer_frozen_payloads,
    chamfer_loss_per_pc,
    nn_distance,
)
from geometric_adv_tpu_torch.ops.emd import emd_loss_fused
from geometric_adv_tpu_torch.parallel import gather_global, local_rows

# Pairs per attack call when the caller gives none: 1,024,000 point rows
# (500 pairs at 2048 points), the JAX package's default dispatch size.
# Autograd keeps the encoder's activations of every row; the peak device
# memory at this size is not measured yet.
MAX_POINT_ROWS = 1_024_000

# The runner's one-shot measurement of the fused against the composed
# chamfer on the card (``_calibrate_chamfer_impl``), as in the JAX package:
# their order changes with the batch and the victim, so the runner measures
# it unless ``chamfer_impl`` forces a route.
_CALIB_BATCH = 64
_CALIB_ITERS = 8
_CALIB_REPS = 3
# one decision per (victim, shape, loss config, batch) per process
_CHAMFER_CALIB_CACHE: dict[tuple, bool] = {}


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


def _check_refresh(chamfer_refresh: int, ae_loss_type: str) -> None:
    if chamfer_refresh and ae_loss_type != "chamfer":
        raise ValueError("chamfer_refresh fast mode requires the chamfer AE loss")


def _total_and_aux(pert, z, target_z, dist_weight, t_re, input_dist_per_pc,
                   max_dist_per_pc, adv, recon, loss_adv_type, loss_dist_type,
                   max_point_pert_weight, max_point_dist_weight):
    """The attack's loss and metrics from its two distances
    (reference: src/adv_ae.py:118-142), shared by both modes."""
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


def make_attack_loss(
    encode: Callable[[torch.Tensor], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
    loss_adv_type: str,
    loss_dist_type: str,
    ae_loss_type: str,
    max_point_pert_weight: float,
    max_point_dist_weight: float,
    chamfer_method: str = "auto",
):
    """Build the attack's (total_loss, aux) function of the perturbation
    (reference: src/adv_ae.py:78-142). ``chamfer_method`` ("auto", "fused",
    "composed") routes both chamfers (``ops.chamfer.chamfer_loss_per_pc``)."""
    _check_loss_types(ae_loss_type, loss_adv_type, loss_dist_type)

    def chamfer(a, b):
        return chamfer_loss_per_pc(a, b, method=chamfer_method)

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
            t_re = chamfer(recon, gt)
            input_dist_per_pc = chamfer(adv, x)
            max_dist_per_pc = input_dist_per_pc  # unused (weight 0)
        else:
            t_re = chamfer(recon, gt)
            # the max-point term needs the per-point d1 vector
            d1, _, d2, _ = nn_distance(adv, x)
            input_dist_per_pc = d1.mean(dim=-1) + d2.mean(dim=-1)
            max_dist_per_pc = d1.amax(dim=-1)
        return _total_and_aux(
            pert, z, target_z, dist_weight, t_re, input_dist_per_pc,
            max_dist_per_pc, adv, recon, loss_adv_type, loss_dist_type,
            max_point_pert_weight, max_point_dist_weight,
        )

    return forward


def _frozen_chamfer_terms(x1: torch.Tensor, p: dict, m: int):
    """(d1 [..., n], the x2-side mean [...]) of a chamfer with the
    assignments frozen in the payloads ``p``, both elementwise in x1. The
    x2 side is the difference-correction form
    ``(sum(d2) - 2 sum(delta . r) + sum(cnt |delta|^2)) / m`` with
    delta = x1 - x1_0 (ops/chamfer.py::chamfer_frozen_payloads); the
    expanded quadratic cancels in float32. Autograd wrt x1 gives the
    reference's scatter-add backward for the frozen assignments."""
    diff = x1 - p["nn1"]
    d1 = (diff * diff).sum(dim=-1)
    delta = x1 - p["x1_0"]
    corr = -2.0 * (delta * p["r"]).sum(dim=(-1, -2)) + (
        p["cnt"] * (delta * delta).sum(dim=-1)
    ).sum(dim=-1)
    return d1, (p["d2sum0"] + corr) / m


def make_frozen_attack_loss(
    encode: Callable[[torch.Tensor], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
    loss_adv_type: str,
    loss_dist_type: str,
    max_point_pert_weight: float,
    max_point_dist_weight: float,
):
    """The frozen-assignment variant of ``make_attack_loss`` (chamfer
    victims): both chamfers in the elementwise frozen forms of ``payloads``
    (recon vs gt, adv vs source). At a refresh step (delta == 0) values and
    gradients equal the exact forward's."""

    def forward(pert, x, target_z, gt, dist_weight, payloads):
        p_recon, p_adv = payloads
        adv = x + pert
        z = encode(adv)
        recon = decode(z)
        d1r, mean_d2r = _frozen_chamfer_terms(recon, p_recon, gt.shape[-2])
        t_re = d1r.mean(dim=-1) + mean_d2r
        d1a, mean_d2a = _frozen_chamfer_terms(adv, p_adv, x.shape[-2])
        input_dist_per_pc = d1a.mean(dim=-1) + mean_d2a
        return _total_and_aux(
            pert, z, target_z, dist_weight, t_re, input_dist_per_pc,
            d1a.amax(dim=-1), adv, recon, loss_adv_type, loss_dist_type,
            max_point_pert_weight, max_point_dist_weight,
        )

    return forward


def make_attack_payload_fn(
    encode: Callable[[torch.Tensor], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
):
    """The refresh step of frozen mode: at the current perturbation, with an
    AE forward of its own and no gradients, one exact payload pass per
    attack chamfer (recon vs gt, adv vs source)."""

    @torch.no_grad()
    def payload_fn(pert, x, gt):
        adv = x + pert
        recon = decode(encode(adv))

        def pack(x1, x2):
            _, d2, nn1, snn1, cnt1 = chamfer_frozen_payloads(x1, x2)
            return {
                "nn1": nn1,
                "r": snn1 - cnt1[..., None] * x1,
                "cnt": cnt1,
                "d2sum0": d2.sum(dim=-1),
                "x1_0": x1,
            }

        return pack(recon, gt), pack(adv, x)

    return payload_fn


def attack_batch(
    encode: Callable[[torch.Tensor], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
    source_pc: torch.Tensor,  # [B, n, 3]
    target_latent: torch.Tensor,  # [B, z]
    target_pc: torch.Tensor,  # [B, m, 3]
    target_ae_loss_ref: torch.Tensor,  # [B]
    dist_weights,  # [W] or [W, B]
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
    track_by: str = "t_re",
    chamfer_method: str = "auto",
    chamfer_refresh: int = 0,
) -> AttackOutputs:
    """Run the full attack for one batch of pairs, all dist weights at once.

    All tensors live on one device. ``dist_weights`` is [W] (one weight a
    run, the standard attack) or [W, B] (per-example weights, the
    binary-search variant). ``track_by`` is the best-so-far key, "t_re"
    (the main attack, reference: src/adv_ae.py:239) or "loss_dist" (the
    binary-search variant, :283-290): the best rows are those of its
    strictly smallest value, and the key is what the metrics' last column
    holds, as in the JAX package. ``pert0`` ([B, n, 3]) replaces the
    seeded init, the same for every weight as in the JAX package.
    ``chamfer_method`` routes the exact mode's chamfers; ``chamfer_refresh``
    = N > 0 runs frozen mode: the steps t = 0..num_iterations are cut into
    chunks of N (the last one shorter where N does not divide them), and a
    payload pass at each chunk's entry perturbation freezes the assignments
    for the chunk, so each chunk's first step has delta == 0. N = 1 follows
    the exact attack up to float32 association. Returns numpy outputs of
    shapes [W, B, 5], [W, B, n, 3], [W, B, m, 3].
    """
    _check_refresh(chamfer_refresh, ae_loss_type)
    if chamfer_refresh:
        forward = make_frozen_attack_loss(
            encode, decode, loss_adv_type, loss_dist_type,
            max_point_pert_weight, max_point_dist_weight,
        )
        payload_fn = make_attack_payload_fn(encode, decode)
    else:
        forward = make_attack_loss(
            encode, decode, loss_adv_type, loss_dist_type, ae_loss_type,
            max_point_pert_weight, max_point_dist_weight, chamfer_method,
        )
    device = source_pc.device
    weights = torch.as_tensor(
        np.asarray(dist_weights, np.float32), device=device
    )
    if track_by not in ("t_re", "loss_dist"):
        raise ValueError(f"unknown track_by {track_by!r}")
    w_count, (b, n, _) = weights.shape[0], source_pc.shape
    m = target_pc.shape[1]

    def fold(t):  # [B, ...] -> [W*B, ...], weight-major like the vmap
        return t.repeat((w_count,) + (1,) * (t.dim() - 1))

    x, tz, gt, ref = (fold(t) for t in (
        source_pc, target_latent, target_pc, target_ae_loss_ref))
    if weights.dim() == 1:
        dist_weight = weights.repeat_interleave(b)
    elif weights.shape == (w_count, b):
        dist_weight = weights.reshape(-1)
    else:
        raise ValueError(f"dist_weights of shape {tuple(weights.shape)} for "
                         f"{b} pairs")
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
    extra = ()

    # steps t = 0..num_iterations: step t records the state after t Adam
    # updates (t = 0 is never recorded since thresh >= 1)
    for t in range(num_iterations + 1):
        last = t == num_iterations
        if chamfer_refresh and t % chamfer_refresh == 0:
            # a chunk starts: the JAX package's divmod(num_iterations + 1,
            # chamfer_refresh) chunks, the remainder chunk included, each
            # refreshed at its entry perturbation; the payloads are
            # per folded row
            extra = (payload_fn(pert, x, gt),)
        pert.requires_grad_(not last)
        with torch.set_grad_enabled(not last):
            total, aux = forward(pert, x, tz, gt, dist_weight, *extra)
            grads = None if last else torch.autograd.grad(total, pert)[0]
        with torch.no_grad():
            if t >= thresh:
                key = aux[track_by]
                better = key < best_key  # strict <
                best_key = torch.where(better, key, best_key)
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


def _auto_dispatch_batch(n_pts: int, n_examples: int | None = None) -> int:
    """Pairs per attack call when none is given: MAX_POINT_ROWS point rows,
    at most ``n_examples``."""
    batch = max(1, MAX_POINT_ROWS // n_pts)
    return batch if n_examples is None else min(batch, n_examples)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_cuda_device(device: torch.device) -> bool:
    """The calibration's device gate (the JAX package's ``_on_tpu()``)."""
    return device.type == "cuda"


def _single_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def _calibrate_chamfer_impl(encode, decode, conf, device, victim_sig=(),
                            calib_batch=None) -> bool:
    """Time the fused and the composed chamfer inside the attack's own
    gradient step (AE forward, its backward wrt the perturbation, both
    chamfers) on ``device`` and return True if fused is at least as fast.

    ``calib_batch`` is the runner's real dispatch batch: the difference
    between the two routes lies in how they overlap the encoder's backward,
    which depends on the batch. Each arm runs once untimed, then
    ``_CALIB_REPS`` times ``_CALIB_ITERS`` steps, each timed between two
    synchronisations; the medians decide. Decisions are cached per
    (victim signature, shape, loss config, batch) for the process.
    """
    b = calib_batch or _CALIB_BATCH
    n = conf.n_input[0]
    m = (conf.n_output or conf.n_input)[0]
    key = (
        victim_sig, n, m, conf.loss_adv_type, conf.loss_dist_type, conf.loss,
        conf.max_point_pert_weight, conf.max_point_dist_weight,
        getattr(conf, "ae_dtype", "float32"), b,
    )
    if key in _CHAMFER_CALIB_CACHE:
        return _CHAMFER_CALIB_CACHE[key]

    rng = np.random.RandomState(123)
    x = torch.as_tensor(rng.rand(b, n, 3).astype(np.float32) - 0.5, device=device)
    # n-sized targets, like the attack pairs (dataset clouds)
    gt = torch.as_tensor(rng.rand(b, n, 3).astype(np.float32) - 0.5, device=device)
    with torch.no_grad():
        tz = encode(gt)
    pert0 = init_pert((b, n, 3), device)

    def run(method):
        forward = make_attack_loss(
            encode, decode, conf.loss_adv_type, conf.loss_dist_type, conf.loss,
            conf.max_point_pert_weight, conf.max_point_dist_weight, method,
        )
        p = pert0
        for _ in range(_CALIB_ITERS):
            p = p.detach().requires_grad_(True)
            g = torch.autograd.grad(forward(p, x, tz, gt, 1.0)[0], p)[0]
            p = p.detach() - 0.01 * g
        _sync(device)

    rates: dict[str, list[float]] = {"fused": [], "composed": []}
    for method in rates:
        run(method)  # warm-up, untimed
    for _ in range(_CALIB_REPS):
        for method in rates:
            _sync(device)
            t0 = time.perf_counter()
            run(method)
            rates[method].append(b * _CALIB_ITERS / (time.perf_counter() - t0))
    fused_rate = float(np.median(rates["fused"]))
    composed_rate = float(np.median(rates["composed"]))
    winner = fused_rate >= composed_rate
    print(
        f"chamfer-impl calibration @[{b}, {n}x{m}] on {device}: "
        f"fused {fused_rate:.0f} vs composed {composed_rate:.0f} "
        f"pair-iters/s -> {'fused' if winner else 'composed'}"
    )
    _CHAMFER_CALIB_CACHE[key] = winner
    return winner


class AttackRunner:
    """Host-side runner: frozen victim AE + the attack loop on ``device``
    (replaces ``AdvAE`` + ``Adversary``, reference: src/adv_ae.py:25-304).

    Routing of a chamfer victim's attack, fixed at construction: frozen mode
    when ``conf.chamfer_refresh`` > 0 (nothing to calibrate: its payload
    pass is K5 on the card); else ``chamfer_impl`` "fused"/"composed" when
    forced; else, on a CUDA device in a single process with n <= 2048, the
    route the calibration measured faster at the runner's dispatch batch
    (``batch_size``: the pairs each attack call gets, which the caller
    knows from its pair grid); else "auto". ``calibration_seconds`` is the
    calibration's wall clock, 0 where none ran.

    ``encoder_vjp`` "sparse" differentiates the encoder through
    ``sparse_encode.make_sparse_encode``, "dense" and "auto" through
    autograd (``models/sparse_encode.py`` says why "auto" is dense);
    ``self.encoder_vjp`` is the path taken.

    ``mesh`` shards each attack call's pairs over its processes (a mesh of
    size 1 is ``None``); with more than one process the calibration stays
    off, as in the JAX package, since ranks timing apart could bind
    different routes.
    """

    def __init__(self, model, conf, device, chamfer_impl: str = "auto",
                 batch_size: int | None = None, encoder_vjp: str = "auto",
                 mesh=None):
        _check_loss_types(conf.loss, conf.loss_adv_type, conf.loss_dist_type)
        if chamfer_impl not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown chamfer_impl {chamfer_impl!r}")
        if encoder_vjp not in ("auto", "sparse", "dense"):
            raise ValueError(f"unknown encoder_vjp {encoder_vjp!r}")
        self.chamfer_refresh = int(getattr(conf, "chamfer_refresh", 0) or 0)
        _check_refresh(self.chamfer_refresh, conf.loss)
        self.model = model.eval().requires_grad_(False)
        self.conf = conf
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.batch_size = batch_size
        self.calibration_seconds = 0.0
        sparse = encoder_vjp == "sparse"
        self.encoder_vjp = "sparse" if sparse else "dense"
        model_encode = (sparse_encode.make_sparse_encode(self.model) if sparse
                        else self.model.encode)

        def encode(x):  # losses and metrics stay float32 for a bf16 victim
            return model_encode(x).float()

        def decode(z):
            return self.model.decode(z).float()

        self.encode, self.decode = encode, decode

        n = conf.n_input[0]
        if self.chamfer_refresh:
            self.chamfer_method = "auto"
        elif chamfer_impl in ("fused", "composed"):
            self.chamfer_method = chamfer_impl
        elif (_single_process() and _on_cuda_device(self.device)
              and conf.loss == "chamfer" and _fused_loss_shape_ok(n)):
            victim_sig = tuple((tuple(p.shape), str(p.dtype))
                               for p in self.model.state_dict().values()
                               ) + (str(getattr(self.model, "dtype", "")),
                                    self.encoder_vjp)
            t0 = time.perf_counter()
            fused = _calibrate_chamfer_impl(
                self.encode, self.decode, conf, self.device,
                victim_sig, calib_batch=batch_size or _auto_dispatch_batch(n),
            )
            self.calibration_seconds = time.perf_counter() - t0
            self.chamfer_method = "fused" if fused else "composed"
        else:
            self.chamfer_method = "auto"

    @property
    def attack_mode(self) -> str:
        """The routing this runner's attack runs: "fused", "composed",
        "auto", or "frozen-<N>" in frozen mode."""
        if self.chamfer_refresh:
            return f"frozen-{self.chamfer_refresh}"
        return self.chamfer_method

    def attack(self, source_pc, target_latent, target_pc, target_ae_loss_ref,
               batch_size: int | None = None, log_file=None,
               pert0: np.ndarray | None = None) -> AttackOutputs:
        """Attack a grid of pairs; returns numpy (metrics [W,N,5],
        adv [W,N,n,3], recon [W,N,m,3]) (reference: src/adv_ae.py:155-189).
        ``batch_size`` pairs go to each call (default: the runner's, else
        MAX_POINT_ROWS point rows); ``pert0`` ([N, n, 3]) replaces the
        seeded init. Under a mesh each call is padded to a multiple of its
        size (the last pair repeated), each rank attacks its rows and the
        gathered call is cut back to its pairs."""
        conf = self.conf
        n_examples = len(source_pc)
        batch_size = batch_size or self.batch_size or _auto_dispatch_batch(
            source_pc.shape[-2], n_examples
        )
        dist_weights = np.asarray(conf.dist_weight_list, np.float32)

        def dev(a, sl):
            """The rows of call ``sl`` of ``a`` that this rank attacks."""
            return local_rows(a[sl], self.mesh, self.device)[0]

        outs = []
        for s in range(0, n_examples, batch_size):
            t0 = time.time()
            sl = slice(s, min(s + batch_size, n_examples))
            out = attack_batch(
                self.encode, self.decode,
                dev(source_pc, sl), dev(target_latent, sl), dev(target_pc, sl),
                dev(target_ae_loss_ref, sl), dist_weights,
                num_iterations=conf.num_iterations,
                num_iterations_thresh=conf.num_iterations_thresh,
                learning_rate=conf.learning_rate,
                loss_adv_type=conf.loss_adv_type,
                loss_dist_type=conf.loss_dist_type,
                ae_loss_type=conf.loss,
                max_point_pert_weight=conf.max_point_pert_weight,
                max_point_dist_weight=conf.max_point_dist_weight,
                pert0=None if pert0 is None else dev(pert0, sl),
                chamfer_method=self.chamfer_method,
                chamfer_refresh=self.chamfer_refresh,
            )
            count = sl.stop - sl.start
            # the pair axis of the [W, pairs, ...] outputs
            outs.append(AttackOutputs(*(
                a[:, :count] for a in gather_global(tuple(out), axis=1))))
            dur = time.time() - t0
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


def binary_search_attack(
    encode: Callable[[torch.Tensor], torch.Tensor],
    decode: Callable[[torch.Tensor], torch.Tensor],
    source_pc,
    target_latent,
    target_pc,
    *,
    device="cuda",
    init_dist_weight: float = 10.0,
    upper_bound_dist_weight: float = 100.0,
    binary_search_step: int = 10,
    num_iterations: int = 500,
    learning_rate: float = 0.01,
    loss_adv_type: str = "chamfer",
    loss_dist_type: str = "chamfer",
    ae_loss_type: str = "chamfer",
):
    """Per-example binary search over the dist weight
    (reference: src/adv_ae.py:253-304, ``_attack_one_batch_binary_step``;
    the JAX package's attack/core.py:835-914).

    Each outer step runs the whole attack on ``device`` with per-example
    weights [1, B], recording from the first iteration by ``loss_dist``
    (strict <), keeps the best by loss_dist over the steps, and bisects: a
    step whose best matches the updated global best counts as a success and
    raises the lower bound, otherwise the upper bound drops.

    Returns numpy (out_best_adv_loss [B], out_best_dist [B],
    out_best_attack [B, n, 3], final dist_weight [B]).
    """
    source_pc = np.asarray(source_pc, np.float32)
    b = len(source_pc)
    lower = np.zeros(b, np.float32)
    weight = np.full(b, init_dist_weight, np.float32)
    upper = np.full(b, upper_bound_dist_weight, np.float32)

    out_best_adv = np.full(b, 1e10, np.float32)
    out_best_dist = np.full(b, 1e10, np.float32)
    out_best_attack = np.ones_like(source_pc)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    inputs = (dev(source_pc), dev(target_latent), dev(target_pc),
              torch.ones(b, device=device))  # the T-NRE normalisation is unused
    for _ in range(binary_search_step):
        out = attack_batch(
            encode, decode, *inputs, weight[None, :],
            num_iterations=num_iterations, num_iterations_thresh=1,
            learning_rate=learning_rate, loss_adv_type=loss_adv_type,
            loss_dist_type=loss_dist_type, ae_loss_type=ae_loss_type,
            track_by="loss_dist",
        )
        best_adv = out.metrics[0, :, 0]  # loss_adv at the best dist
        best_dist = out.metrics[0, :, 1]
        improved = best_dist < out_best_dist
        out_best_dist = np.where(improved, best_dist, out_best_dist)
        out_best_adv = np.where(improved, best_adv, out_best_adv)
        out_best_attack = np.where(improved[:, None, None], out.pc_input[0],
                                   out_best_attack)

        success = best_dist <= out_best_dist
        lower = np.where(success, np.maximum(lower, weight), lower)
        upper = np.where(~success, np.minimum(upper, weight), upper)
        weight = (lower + upper) / 2.0

    return out_best_adv, out_best_dist, out_best_attack, weight
