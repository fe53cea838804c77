#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``geometric_adv_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each followed by ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero:

1. print the card's name and power limit, pin float32 matmuls (no TF32);
2. build every hand-written CUDA kernel from ``geometric_adv_tpu_torch/csrc``
   (one ``nvcc -c`` per source, all at once, then one link);
3. kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card at the main path's shapes, both timed (CUDA events), each time
   beside its bound (``kernel_bound``):
   - K1, K2 and K5 at [24, 2048^2] (the attack's call), [64, 2048^2] and
     [250, 2048^2] (the reference batch), K2 also at [512, 2048^2] (the
     chamfer matrix's block), on clouds whose exact ties straddle K1's
     tile, block, step and chunk boundaries: K1 and K2 bit-equal to their
     plain versions with every tie at its first index, K5's d/i bit-equal
     to K1's, nn1 = x2[i1], snn1 and cnt1 bit-equal to the host's
     ascending-j sums, every second run bit-equal to the first;
   - K1/K2/K3/K4 at [64, 2048, 3] clouds and a ragged 2000 x 2048 case,
     with exact ties: K1 and K2 values bit-equal and K1 indices equal, K3
     within 2.6e-6, K4 within 2.6e-6 of its plain version and of K3;
   - K3 at [24, 64, 250] x 2048^2 on tie clouds and on clouds whose x2
     clusters on three x1 points: bit-equal to the host's ascending-j sums,
     within 2.6e-6 of the card's plain version, second runs bit-equal;
     timed by torch.profiler (the kernel is shorter than its wrapper's host
     time, which CUDA events measure);
   - K5 at [64, 2048^2], [64, 1024^2] and the ragged [16, 2000 x 2048],
     [8, 1100 x 300], [8, 2500 x 2048]: d1 i1 d2 i2 bit-equal to K1 and the
     plain version, nn1 = x2[i1], cnt1 equal, snn1 bit-equal to the host's
     ascending-j sum; the frozen attack's payload op launches K5 at every
     shape, past 2048 points too;
   - K8 (``nn_distance_hier``) on tie clouds and on the synthetic dataset's
     surface clouds at [64, 2048^2]: values bit-equal to K1, indices equal;
     timed beside K1;
   - K6/K7 (the EMD sweep) at [50, 1024^2] (K6, K7 and each other),
     [24, 2048^2] and [50, 2048^2] (K7) and the ragged [8, 1024 x 512],
     [8, 500 x 1000]: cost rtol 1e-5, gradients atol 1e-4 * max|g|, in
     grads mode with and without g2 and value-only, whose cost must be
     bit-equal, second runs bit-equal; K7's numerics scanned on the card
     (expf is +0 exactly below its skip threshold, its square root from
     the gradient's rsqrt is sqrtf's) and the share of (warp, element)
     pairs it skips at each level printed;
4. six legs through the port's stage CLIs on ``--device cuda``, each with
   the launch counts zeroed just before and read just after:
   - chamfer: ``train_ae --loss chamfer`` (2048 points, 2 epochs), tst_ae,
     prepare_indices_for_attack (all three index kinds), run_attack
     (500/400 iterations, routed by the runner's calibration),
     get_dists_per_point, evaluate_attack; K1, K2 and K3 must launch;
   - frozen-10: run_attack ``--chamfer_refresh 10`` on the same victim; K5
     must launch exactly on the refresh schedule, K1, K2, K3 never;
   - fused: run_attack ``--chamfer_impl fused``; K5 must launch, K1 and K3
     never;
   - EMD: ``train_ae --loss emd`` (2048 points, batch 50, 3 epochs), then the
     same stages with run_attack cut to 100/80 iterations; K7 and K2 must
     launch;
   - EMD at 1024 points: ``train_ae --loss emd --n_points 1024`` (2 epochs)
     and tst_ae; K6 must launch;
   - chamfer at 1024 points: ``train_ae --loss chamfer --n_points 1024``
     (2 epochs) and tst_ae; K5 (the fused loss) must launch;
   all on a synthetic dataset of sphere, cube, torus and cone, 60 clouds each;
5. output checks per leg: every artifact has the JAX stages' shape and is
   finite, the training loss falls, each attack lowers the mean target
   reconstruction error, and each attack on the card agrees with the same
   attack on the host CPU (plain versions) on a small input: all metrics for
   chamfer (exact, frozen-10 and fused), and for the EMD victim with the
   perturbation-norm distance; the target-reconstruction metrics with the
   EMD distance; the frozen attack refreshed every step agrees with the
   exact one on the card;
6. rates: train samples/s per leg, attack pair-iterations/s of every attack
   leg and, for the exact, frozen-10 and fused chamfer attacks, at the
   reference's batch of 250 pairs and for the EMD attack at its 24 pairs
   per call (each with a torch.profiler breakdown and the port's kernels'
   share by source), the chamfer matrix's pair-evaluations/s, and the peak
   device memory of each leg.

Its last lines are a JSON record of the kernels (each with its shape, its
time and how it was taken (``ms_by``), the plain version's, its bound and
what sets it, and its launches over the legs), the card as nvidia-smi
reports it, and
``{"ok": true, "device": {...}}``. It writes only under
``build/`` in the checkout.
"""

from __future__ import annotations

import json
import os.path as osp
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from geometric_adv_tpu_torch.ops.cuda.timing import device_timed, sync_timed

ROOT = osp.dirname(osp.abspath(__file__))
WORK = osp.join(ROOT, "build", "chip_smoke")
CLASSES = ["sphere", "cube", "torus", "cone"]
N_POINTS = 2048
GRAD_TOL = 2.6e-6  # DESIGN.md section 6 gradient bar
SNN_TOL = 1e-5  # K5's scatter sum (geometric_adv_tpu/cli/verify_tpu.py:409-416)
EMD_COST_RTOL = 1e-5  # geometric_adv_tpu/cli/verify_tpu.py:482
EMD_GRAD_REL = 1e-4
EMD_ITERS = (100, 80)  # the EMD leg's attack, cut from the reference 500/400
FORWARD_BATCHES = (24, 64, 250, 512)  # the attack's call, the kernel table's
# shape, the reference batch; 512, the chamfer matrix's block (K2 only)
RECORD_BATCH = 64  # the batch of the JSON line's K1-K5 records (the kernel table's)
K3_CLUSTERED = ((2, 300, 2500), (3, N_POINTS, 600))  # x2 on three x1 points
EMD_ATTACK_PAIRS = 24  # the EMD attack's pairs per call (K7 at [24, 2048^2])
# what a record's "ms" is: a call's time by CUDA events around back-to-back
# calls, or, for K3 (shorter than its wrapper's host time), the kernel's own
# time on the device
EVENT_TIME = "CUDA events per call"
DEVICE_TIME = "torch.profiler device time per call"
# published peaks of one H100 SXM (NVIDIA's H100 datasheet), for bounds
FP32_PEAK, FP64_PEAK, HBM_RATE = 67e12, 34e12, 3.35e12
CSRC = "geometric_adv_tpu_torch/csrc/"
PALLAS = "geometric_adv_tpu/ops/pallas/"
KERNELS = {  # wrapper: (source, the TPU kernel it replaces)
    "nn_distance_cuda": (CSRC + "nn_distance.cu", PALLAS + "chamfer_kernel_v2.py:258"),
    "nn_distance_values_cuda": (CSRC + "nn_distance.cu",
                                PALLAS + "chamfer_kernel_v2.py:194"),
    "chamfer_grad1_cuda": (CSRC + "chamfer_grad.cu", PALLAS + "chamfer_bwd_kernel.py:298"),
    "chamfer_grad1_vpu_cuda": (CSRC + "chamfer_grad.cu",
                               PALLAS + "chamfer_bwd_kernel.py:212"),
    "chamfer_loss_payloads_cuda": (CSRC + "chamfer_payloads.cu",
                                   PALLAS + "chamfer_loss_kernel.py:336"),
    "nn_direction_hier_cuda": (CSRC + "nn_hier.cu", PALLAS + "chamfer_hier_kernel.py:237"),
    "emd_sweep_block_cuda": (CSRC + "emd_sweep.cu", PALLAS + "emd_fused_kernel.py:179"),
    "emd_sweep_tiled_cuda": (CSRC + "emd_sweep.cu", PALLAS + "emd_round_kernel.py:268"),
}


# the port's own kernel functions by source, for the profiles' shares
OWN_KERNELS = {
    "nn_distance.cu (K1, K2)": ("nn_kernel",),
    "chamfer_grad.cu (K3, K4)": ("grad1_kernel", "grad1_vpu_kernel"),
    "chamfer_payloads.cu (K5's payload pass)": ("payload_kernel",),
    "emd_sweep.cu (K6, K7)": ("emd_block_kernel", "tiled_"),
    "nn_hier.cu (K8)": ("hier_kernel",),
}


def fail(msg: str):
    raise RuntimeError(msg)


def tie_clouds(b, n, m, seed):
    """Seeded uniform clouds with exact ties: a duplicated point in each
    cloud and a query point that coincides with a point of the other; at
    2048 points and more, ties that straddle K1's boundaries
    (tests/test_torch_ops_chamfer_ties.py): rows 3 and 1500 (other tiles
    and blocks) on column 7, columns 5 and 1800 (other steps) on row 40,
    rows 255/256 (a tile boundary) on column 300, columns 255/256 (a step
    boundary) on row 600, past 2048 rows also row 2100 on column 7."""
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x2[:, 5] = x2[:, 17]
    x1[:, 9] = x1[:, 41]
    x1[:, 3] = x2[:, 7]
    if n >= 2048 and m >= 2048:
        x1[:, 1500] = x2[:, 7]
        x2[:, 1800] = x2[:, 5]
        x1[:, 40] = x2[:, 5]
        x1[:, 255] = x1[:, 256] = x2[:, 300]
        x2[:, 256] = x2[:, 255]
        x1[:, 600] = x2[:, 255]
        if n > 2100:
            x1[:, 2100] = x2[:, 7]
    return torch.from_numpy(x1).cuda(), torch.from_numpy(x2).cuda()


def check_straddling_ties(k1, shape):
    """K1's argmins at the ties tie_clouds plants at 2048 points."""
    d1, i1, d2, i2 = k1
    want = ((i2[:, 7], 3), (i1[:, 40], 5), (i2[:, 300], 255), (i1[:, 600], 255),
            (i1[:, 3], 7))
    if not all(bool((got == w).all()) for got, w in want):
        fail(f"K1 missed a straddling tie's first index at {shape}")
    if not (bool((d2[:, 7] == 0).all()) and bool((d1[:, 600] == 0).all())):
        fail(f"K1's straddling ties are not at distance 0 at {shape}")


def kernel_bound(name, b, n, m, pairs=None, zero_share=None):
    """(bound_ms, bound_by, the operations' type) of one call at [b, n, 3] x
    [b, m, 3]: the larger of the operations over the card's peak for their
    type and the bytes over its memory rate, each input read once and each
    output written once. Operations per distance pair: 8 FP32 for the
    distance (3 sub, 3 mul, 2 add) and a minimum per direction (K1, K2, K5;
    one direction on the ``pairs`` K8's pruning needs); per pair and level
    of the EMD sweep (g1 mode), 27 FP32 (the distance, the kernel value, the
    row, column and cost products and sums, the g1 terms) and 6 FP64 (its
    three float64 sums, product and add), but only the distance (8 FP32) for
    the ``zero_share`` of a level's pairs whose kernel value is exactly +0
    (K7 skips their terms); K3/K4 are O(n + m)."""
    levels = 10
    cloud = b * (n + m) * 12
    fp32 = fp64 = 0.0
    if name in ("nn_distance_cuda", "nn_distance_values_cuda", "chamfer_loss_payloads_cuda"):
        fp32 = 10.0 * b * n * m
        out = {"nn_distance_cuda": 8 * (n + m), "nn_distance_values_cuda": 4 * (n + m),
               "chamfer_loss_payloads_cuda": 8 * (n + m) + 28 * n}[name]
        nbytes = cloud + b * out
    elif name in ("chamfer_grad1_cuda", "chamfer_grad1_vpu_cuda"):
        fp32 = 20.0 * b * (n + m)
        nbytes = cloud + b * (8 * (n + m) + 12 * n)  # idx, g in; grad out
    elif name == "nn_direction_hier_cuda":
        fp32 = 9.0 * pairs
        nbytes = cloud + b * (4 * n + 4 * m + 16 * -(-m // 128) + 8 * n)
    else:  # the EMD sweeps, g1 only
        live = levels - sum(zero_share or ())
        fp32 = (8.0 * levels + 19.0 * live) * b * n * m
        fp64 = 6.0 * live * b * n * m
        nbytes = cloud + b * (4 + 12 * n)
    times = {"FP32": fp32 / FP32_PEAK, "FP64": fp64 / FP64_PEAK, "bytes": nbytes / HBM_RATE}
    kind = max(times, key=times.get)
    return times[kind] * 1e3, "bytes" if kind == "bytes" else "operations", kind


def chamfer_kernel_phase(cu, ch):
    """K1/K2/K3/K4 against their plain versions, K4 also against K3;
    returns the record of K4 (K1 and K2 are timed in forward_kernel_phase,
    K3 in grad_kernel_phase)."""
    records = {}
    for b, n, m in ((64, N_POINTS, N_POINTS), (16, 2000, N_POINTS)):
        x1, x2 = tie_clouds(b, n, m, seed=n)
        d1, i1, d2, i2 = cu.nn_distance_cuda(x1, x2)
        r1, j1, r2, j2 = ch.nn_distance_plain(x1, x2)
        v1, v2 = cu.nn_distance_values_cuda(x1, x2)
        g = torch.Generator(device="cpu").manual_seed(b)
        g1 = torch.rand(b, n, generator=g).cuda()
        g2 = torch.rand(b, m, generator=g).cuda()
        k3 = cu.chamfer_grad1_cuda(x1, x2, i1, i2, g1, g2)
        p3 = ch.chamfer_grad1_plain(x1, x2, i1, i2, g1, g2)
        k4 = cu.chamfer_grad1_vpu_cuda(x1, x2, i1, i2, g1, g2)
        # K4's plain version on the host: its scatter sums run in ascending
        # j, as K4's do; the card's atomic scatter sums in another order,
        # which K4's x1 * cnt - sc cancellation magnifies (printed)
        p4 = ch.chamfer_grad1_vpu_plain(
            *(t.cpu() for t in (x1, x2, i1, i2, g1, g2))).cuda()
        p4_card = ch.chamfer_grad1_vpu_plain(x1, x2, i1, i2, g1, g2)
        torch.cuda.synchronize()
        shape = f"[{b},{n},3]x[{b},{m},3]"
        if not (torch.equal(d1, r1) and torch.equal(d2, r2)):
            fail(f"K1 distances differ from the plain version at {shape}")
        if not (torch.equal(i1, j1) and torch.equal(i2, j2)):
            fail(f"K1 indices differ from the plain version at {shape}")
        if not (torch.equal(v1, r1) and torch.equal(v2, r2)):
            fail(f"K2 distances differ from the plain version at {shape}")
        k3_err = (k3 - p3).abs().max().item()
        if not k3_err <= GRAD_TOL:
            fail(f"K3 differs from the plain version by {k3_err} at {shape}")
        k4_err = (k4 - p4).abs().max().item()
        k4_k3 = (k4 - k3).abs().max().item()
        k4_card = (k4 - p4_card).abs().max().item()
        print(f"kernel check {shape}: K1 values+indices bit-equal, K2 "
              f"bit-equal, K3 max abs err {k3_err:.3g}, K4 {k4_err:.3g} from its "
              f"plain version and {k4_k3:.3g} from K3 (tol {GRAD_TOL}); K4 "
              f"{k4_card:.3g} from its plain version on the card (atomic order)")
        if not (k4_err <= GRAD_TOL and k4_k3 <= GRAD_TOL):
            fail(f"K4 differs from its plain version or K3 at {shape}")
        if n == m:  # time at the main-path shape
            ms = sync_timed(lambda: cu.chamfer_grad1_vpu_cuda(x1, x2, i1, i2, g1, g2), 20)
            plain_ms = sync_timed(lambda: ch.chamfer_grad1_vpu_plain(
                x1, x2, i1, i2, g1, g2), 5)
            records["chamfer_grad1_vpu_cuda"] = {"max_abs_err": k4_err, "ms": ms,
                                                 "plain_ms": plain_ms, "bnm": (b, n, m)}
            print(f"  chamfer_grad1_vpu_cuda at {shape}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms")
        del x1, x2, d1, i1, d2, i2, r1, j1, r2, j2, v1, v2, k3, p3, k4, p4, p4_card
    torch.cuda.synchronize()
    return records


def grad_kernel_phase(cu, ch):
    """K3 on tie clouds at FORWARD_BATCHES[:3] x 2048^2 and on clouds whose
    x2 clusters on three x1 points (K3_CLUSTERED: segments of hundreds of
    j, most segments empty), with the K1 argmins: bit-equal to the plain
    version on the host, whose scatter sums run in ascending j as K3's do
    (tests/test_torch_ops_chamfer_ties.py pins it to an explicit loop),
    within GRAD_TOL of the plain version on the card (an atomic scatter), a
    second run bit-equal to the first. Timed on the tie clouds beside its
    bound: the kernel's own time (torch.profiler, 50 calls), which is
    shorter than the wrapper's host time that CUDA events around the calls
    measure (both printed). Returns the record at RECORD_BATCH."""
    records = {}
    cases = ([("tie clouds", b, N_POINTS, N_POINTS) for b in FORWARD_BATCHES[:3]]
             + [("clustered clouds", b, n, m) for b, n, m in K3_CLUSTERED])
    for kind, b, n, m in cases:
        rng = np.random.RandomState(b * n + m)
        if kind == "tie clouds":
            x1, x2 = tie_clouds(b, n, m, seed=b + 1)
        else:
            a = rng.rand(b, n, 3).astype(np.float32)
            c = (a[:, rng.randint(0, 3, m)] + 1e-3 * rng.rand(b, m, 3)).astype(np.float32)
            x1, x2 = torch.from_numpy(a).cuda(), torch.from_numpy(c).cuda()
        _, i1, _, i2 = cu.nn_distance_cuda(x1, x2)
        g1, g2 = (torch.from_numpy(rng.rand(b, k).astype(np.float32)).cuda() for k in (n, m))
        args = (x1, x2, i1, i2, g1, g2)
        got = cu.chamfer_grad1_cuda(*args)
        again = cu.chamfer_grad1_cuda(*args)
        plain = ch.chamfer_grad1_plain(*args)
        host = ch.chamfer_grad1_plain(*(t.cpu() for t in args))
        torch.cuda.synchronize()
        shape = f"[{b},{n},3]x[{b},{m},3]"
        err = (got - plain).abs().max().item()
        if not torch.equal(got.cpu(), host):
            fail(f"K3 differs from the host's ascending-j sums on the {kind} {shape}")
        if not torch.equal(again, got):
            fail(f"K3's second run differs from its first on the {kind} {shape}")
        if not err <= GRAD_TOL:
            fail(f"K3 differs from the plain version by {err} on the {kind} {shape}")
        print(f"kernel check K3 on the {kind} {shape}: bit-equal to the host's "
              f"ascending-j sums, second run bit-equal, max abs err {err:.3g} from the "
              f"card's plain version (tol {GRAD_TOL})")
        if kind == "tie clouds":
            ms = device_timed(lambda: cu.chamfer_grad1_cuda(*args), 50)
            call_ms = sync_timed(lambda: cu.chamfer_grad1_cuda(*args), 50)
            bound_ms = kernel_bound("chamfer_grad1_cuda", b, n, m)[0]
            print(f"  chamfer_grad1_cuda at {shape}: {ms:.4f} ms on the device, "
                  f"{call_ms:.4f} ms a call by CUDA events; bound {bound_ms:.4f} ms "
                  f"({100 * bound_ms / ms:.1f}%)")
            if b == RECORD_BATCH:
                records["chamfer_grad1_cuda"] = {
                    "max_abs_err": err, "ms": ms, "ms_by": DEVICE_TIME, "call_ms": call_ms,
                    "plain_ms": sync_timed(lambda: ch.chamfer_grad1_plain(*args), 5),
                    "bnm": (b, n, m)}
        del x1, x2, args, got, again, plain, host
    torch.cuda.synchronize()
    return records


def forward_kernel_phase(cu, ch):
    """K1, K2 and K5 on tie clouds of 2048 points at FORWARD_BATCHES, with
    ties straddling K1's tile, block, step and chunk boundaries: K1 and K2
    bit-equal to their plain versions (at 512 clouds, where the plain
    version's [b, n, m, 3] plane would take 51 GB, K2 bit-equal to K1's
    distances), K5's d/i bit-equal to K1's, nn1 = x2[i1], cnt1 equal and
    snn1 bit-equal to the plain version on the host (ascending j, as K5
    sums) on two of the clouds, every kernel's second run bit-equal to its
    first; each timed (CUDA events, 20 calls; the plain versions, 3 calls,
    at RECORD_BATCH). Returns the records at RECORD_BATCH, each with its
    times at every batch."""
    names = ("nn_distance_cuda", "nn_distance_values_cuda", "chamfer_loss_payloads_cuda")
    records = {name: {"shapes_ms": {}} for name in names}
    n = N_POINTS
    for b in FORWARD_BATCHES:
        x1, x2 = tie_clouds(b, n, n, seed=b)
        shape = f"[{b},{n},3]^2"
        calls = {"nn_distance_cuda": lambda: cu.nn_distance_cuda(x1, x2),
                 "nn_distance_values_cuda": lambda: cu.nn_distance_values_cuda(x1, x2),
                 "chamfer_loss_payloads_cuda": lambda: cu.chamfer_loss_payloads_cuda(x1, x2)}
        if b == 512:  # K2 alone: the matrix's block
            del calls["chamfer_loss_payloads_cuda"]
        outs = {name: fn() for name, fn in calls.items()}
        k1, k2 = outs["nn_distance_cuda"], outs["nn_distance_values_cuda"]
        want = ch.nn_distance_plain(x1, x2) if b < 512 else k1
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(k1, want)):
            fail(f"K1 differs from its plain version at {shape}")
        check_straddling_ties(k1, shape)
        if not (torch.equal(k2[0], want[0]) and torch.equal(k2[1], want[2])):
            fail(f"K2 differs from the plain version (at 512 clouds K1) at {shape}")
        errs = {"nn_distance_cuda": 0.0, "nn_distance_values_cuda": 0.0}
        if "chamfer_loss_payloads_cuda" in outs:
            k5 = outs["chamfer_loss_payloads_cuda"]
            host = ch.chamfer_loss_payloads_plain(x1[:2].cpu(), x2[:2].cpu())
            if not all(torch.equal(k5[k], k1[k]) for k in range(4)):
                fail(f"K5's d1 i1 d2 i2 differ from K1's at {shape}")
            if not torch.equal(k5[4], ch._take_points(x2, k1[1])):
                fail(f"K5 nn1 is not x2[i1] at {shape}")
            if not (torch.equal(k5[5][:2].cpu(), host[5])
                    and torch.equal(k5[6][:2].cpu(), host[6])):
                fail(f"K5 snn1 or cnt1 differ from the host's ascending-j sums at {shape}")
            errs["chamfer_loss_payloads_cuda"] = (k5[5][:2].cpu() - host[5]).abs().max().item()
        for name, fn in calls.items():
            again = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(f, g) for f, g in zip(outs[name], again)):
                fail(f"{name}'s second run differs from its first at {shape}")
        times = {name: sync_timed(fn, 20) for name, fn in calls.items()}
        for name, ms in times.items():
            records[name]["shapes_ms"][shape] = ms
            bound_ms = kernel_bound(name, b, n, n)[0]
            print(f"  {name} at {shape}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({100 * bound_ms / ms:.1f}%)")
        if b == RECORD_BATCH:
            plains = {"nn_distance_cuda": lambda: ch.nn_distance_plain(x1, x2),
                      "nn_distance_values_cuda": lambda: ch.nn_distance_values_plain(x1, x2),
                      "chamfer_loss_payloads_cuda":
                          lambda: ch.chamfer_loss_payloads_plain(x1, x2)}
            for name in names:
                records[name].update(max_abs_err=errs[name], ms=times[name],
                                     plain_ms=sync_timed(plains[name], 3), bnm=(b, n, n))
        k5_note = (", K5 d/i = K1, nn1 = x2[i1], snn1 and cnt1 bit-equal to the host"
                   if b < 512 else "")
        print(f"kernel check {shape}: K1 and K2 bit-equal to "
              f"{'their plain versions' if b < 512 else 'each other'}, straddling ties at "
              f"their first index{k5_note}; second runs bit-equal")
        del x1, x2, k1, k2, want, outs, calls
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return records


def payload_kernel_phase(cu, ch):
    """K5 against K1, its plain version and the gather x2[i1], snn1 against
    the host's ascending-j sum, at the attack's and the 1024-point trainer's
    shapes and three ragged ones, one past the fused loss's 2048-point gate;
    the frozen attack's payload op (``chamfer_frozen_payloads``) must launch
    K5 once at each shape."""
    names = ("d1", "i1", "d2", "i2", "nn1", "snn1", "cnt1")
    for b, n, m in ((64, N_POINTS, N_POINTS), (64, 1024, 1024), (16, 2000, N_POINTS),
                    (8, 1100, 300), (8, 2500, N_POINTS)):
        x1, x2 = tie_clouds(b, n, m, seed=n + m + 1)
        got = cu.chamfer_loss_payloads_cuda(x1, x2)
        want = ch.chamfer_loss_payloads_plain(x1, x2)
        k1 = cu.nn_distance_cuda(x1, x2)
        before = cu.launch_counts()["chamfer_loss_payloads_cuda"]
        frozen = ch.chamfer_frozen_payloads(x1, x2)
        torch.cuda.synchronize()
        shape = f"[{b},{n},3]x[{b},{m},3]"
        if cu.launch_counts()["chamfer_loss_payloads_cuda"] != before + 1:
            fail(f"the frozen payloads did not launch K5 at {shape}")
        if not all(torch.equal(f, got[k]) for f, k in zip(frozen, (0, 2, 4, 5, 6))):
            fail(f"the frozen payloads differ from K5's outputs at {shape}")
        for k in range(4):
            if not (torch.equal(got[k], want[k]) and torch.equal(got[k], k1[k])):
                fail(f"K5 {names[k]} differs from K1 or the plain version at {shape}")
        if not torch.equal(got[4], ch._take_points(x2, got[1])):
            fail(f"K5 nn1 is not x2[i1] at {shape}")
        if not torch.equal(got[6], want[6]):
            fail(f"K5 cnt1 differs from the plain version at {shape}")
        host = ch.chamfer_loss_payloads_plain(x1[:2].cpu(), x2[:2].cpu())
        if not torch.equal(got[5][:2].cpu(), host[5]):
            fail(f"K5 snn1 differs from the host's ascending-j sum at {shape}")
        snn_err = (got[5] - want[5]).abs().max().item()
        print(f"kernel check K5 {shape}: d1 i1 d2 i2 bit-equal to K1 and the plain "
              f"version, nn1 = x2[i1], cnt1 equal, snn1 bit-equal to the host's "
              f"ascending-j sum (max abs err {snn_err:.3g} from the card's plain "
              f"version, whose atomic scatter sums in another order; tol {SNN_TOL}); "
              "the frozen payloads launched K5")
        if not snn_err <= SNN_TOL:
            fail(f"K5 snn1 differs from the plain version at {shape}")
        if b == 64 and n == 1024:
            ms = sync_timed(lambda: cu.chamfer_loss_payloads_cuda(x1, x2), 20)
            plain_ms = sync_timed(lambda: ch.chamfer_loss_payloads_plain(x1, x2), 5)
            print(f"  chamfer_loss_payloads_cuda at {shape}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms")
        del x1, x2, got, want, k1, frozen, host
    torch.cuda.synchronize()


def surface_clouds(b, n, seed):
    """Two [b, n, 3] batches of the synthetic dataset's shapes on the card."""
    from geometric_adv_tpu_torch.data.synthetic import sample_shape

    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(np.stack([
        sample_shape(CLASSES[i % len(CLASSES)], n, rng) for i in range(b)
    ]).astype(np.float32)).cuda() for _ in range(2))


def hier_kernel_phase(cu, hier, ch):
    """K8: ``nn_distance_hier`` (K8 for both directions) bit-equal to K1,
    values and indices, on tie clouds and surface clouds; on the sorted
    surface clouds each direction against its plain version, timed beside
    K1 at the same shape."""
    b = 64
    cases = {
        f"tie clouds [{b},{N_POINTS},3]^2": tie_clouds(b, N_POINTS, N_POINTS, seed=5),
        "tie clouds [16,2000,3]x[16,2048,3]": tie_clouds(16, 2000, N_POINTS, seed=6),
        f"surface clouds [{b},{N_POINTS},3]^2": surface_clouds(b, N_POINTS, seed=3),
    }
    for label, (x, y) in cases.items():
        got = hier.nn_distance_hier(x, y)
        want = cu.nn_distance_cuda(x, y)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"K8 differs from K1 on the {label}")
        print(f"kernel check K8 on the {label}: values bit-equal to K1, indices equal")
    x, y = cases[f"surface clouds [{b},{N_POINTS},3]^2"]
    xs, px, cyr_x = hier._prep(x)
    ys, py, cyr_y = hier._prep(y)
    args = ((xs, hier.seed_upper_bounds(xs, cyr_y), ys, py, cyr_y),
            (ys, hier.seed_upper_bounds(ys, cyr_x), xs, px, cyr_x))
    err = 0.0
    for a in args:
        got = cu.nn_direction_hier_cuda(*a)
        want = hier.nn_direction_hier_plain(*a)
        torch.cuda.synchronize()
        err = max(err, (got[0] - want[0]).abs().max().item())
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail("K8 differs from its plain version on the sorted surface clouds")
    pairs = hier_needed_pairs(hier, ch, args[0][0], args[0][4],
                              cu.nn_direction_hier_cuda(*args[0], with_idx=False)[0],
                              y.shape[1])
    ms = sync_timed(lambda: cu.nn_direction_hier_cuda(*args[0]), 20)
    plain_ms = sync_timed(lambda: hier.nn_direction_hier_plain(*args[0]), 3)
    both_ms = sync_timed(lambda: [cu.nn_direction_hier_cuda(*a) for a in args], 20)
    full_ms = sync_timed(lambda: hier.nn_distance_hier(x, y), 10)
    k1_ms = sync_timed(lambda: cu.nn_distance_cuda(x, y), 20)
    tx, ty = cases[f"tie clouds [{b},{N_POINTS},3]^2"]
    tie_ms = sync_timed(lambda: hier.nn_distance_hier(tx, ty), 10)
    print(f"  nn_direction_hier_cuda on the sorted surface clouds: one direction "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms), both directions {both_ms:.4f} "
          f"ms; nn_distance_hier with its sorts {full_ms:.4f} ms (uniform tie "
          f"clouds {tie_ms:.4f} ms); K1 at the same shape {k1_ms:.4f} ms")
    torch.cuda.synchronize()
    print(f"  K8's pruning leaves {pairs / (b * N_POINTS * N_POINTS):.3f} of the "
          "direction's pairs, at the final distances (the bound's operations)")
    return {"nn_direction_hier_cuda": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "bnm": (b, N_POINTS, N_POINTS), "pairs": pairs}}


def hier_needed_pairs(hier, ch, x, cyr, d, m):
    """Distance pairs K8's exact pruned search must evaluate on these
    clouds: a block of sorted points is needed by a tile of NT queries where
    some query's lower bound to its sphere (the kernel's formula) is at most
    that query's final NN distance; each such (tile, block) costs NT x the
    block's points."""
    b, n, _ = x.shape
    gap = torch.clamp(torch.sqrt(ch.pairwise_sqdist(x, cyr[..., :3])) - cyr[:, None, :, 3],
                      min=0.0)
    need = (gap * gap * hier._LB_MARGIN - hier._ABS_MARGIN) <= d[..., None]
    tiles = -(-n // hier.NT)
    need = torch.nn.functional.pad(need, (0, 0, 0, tiles * hier.NT - n))
    need = need.reshape(b, tiles, hier.NT, -1).any(dim=2)
    sizes = torch.tensor([min(hier.BS, m - j * hier.BS) for j in range(need.shape[-1])],
                         device=x.device, dtype=torch.float64)
    return float((need.double() * sizes).sum().item()) * hier.NT


def sweep_errors(got, want):
    """(cost relative error, gradient error as a share of max|g|, max abs
    error) of a sweep against its plain version; missing gradients skip."""
    cost, g1, g2 = got
    c_ref, g1_ref, g2_ref = want
    rel = ((cost - c_ref).abs() / c_ref.abs()).max().item()
    abs_err = (cost - c_ref).abs().max().item()
    scale = max(g1_ref.abs().max().item(), 1e-30)
    g_rel = 0.0
    for g, r in ((g1, g1_ref), (g2, g2_ref)):
        if g is not None:
            err = (g - r).abs().max().item()
            g_rel, abs_err = max(g_rel, err / scale), max(abs_err, err)
    return rel, g_rel, abs_err


def emd_kernel_phase(cu_emd, emd):
    """K6/K7 against the plain sweep in every mode; value-only costs
    bit-equal to grads mode; second runs bit-equal; K7's numerics on the
    card (``numerics_scan``: expf's underflow threshold, the square root
    from rsqrt) and the share of (warp, element) pairs it skips at each
    level; times at the main path's shapes (K6 [50, 1024^2]; K7 [50, 2048^2]
    and the EMD attack's [24, 2048^2]; mean of 10 kernel calls and 3 plain
    calls) in its mode, g1 only."""
    scan = cu_emd.numerics_scan(torch.device("cuda"))
    print(f"kernel check K7's numerics on the card: {scan}")
    if (scan["expf_mismatches"] or scan["sqrt_mismatches"]
            or scan["most_negative_positive"] != cu_emd.EXP_UNDERFLOW):
        fail(f"K7's numerics do not hold on this card: {scan}")
    kernels = {"K6": cu_emd.emd_sweep_block_cuda, "K7": cu_emd.emd_sweep_tiled_cuda}
    records = {}
    for b, n, m, names in ((8, 1024, 512, "K6 K7"), (8, 500, 1000, "K6 K7"),
                           (50, 1024, 1024, "K6 K7"),
                           (EMD_ATTACK_PAIRS, N_POINTS, N_POINTS, "K7"),
                           (50, N_POINTS, N_POINTS, "K7")):
        rng = np.random.RandomState(n + m)
        x = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32) - 0.5).cuda()
        y = torch.from_numpy(rng.rand(b, m, 3).astype(np.float32) - 0.5).cuda()
        want = emd.emd_sweep_plain(x, y, True, True)
        shape = f"[{b},{n},3]x[{b},{m},3]"
        outs = {}
        for name in names.split():
            fn = kernels[name]
            full = fn(x, y, emd._LEVELS, True, True)
            worst = (0.0, 0.0, 0.0)
            for flags in ((True, True), (True, False), (False, True), (False, False)):
                got = full if flags == (True, True) else fn(x, y, emd._LEVELS, *flags)
                torch.cuda.synchronize()
                if (got[1] is None) == flags[0] or (got[2] is None) == flags[1]:
                    fail(f"{name} returned the wrong gradients for {flags}")
                if not torch.equal(got[0], full[0]):
                    fail(f"{name} cost in mode {flags} is not bit-equal to grads mode")
                errs = sweep_errors(got, want)
                if not (errs[0] <= EMD_COST_RTOL and errs[1] <= EMD_GRAD_REL):
                    fail(f"{name} differs from the plain sweep at {shape} {flags}: "
                         f"cost rel {errs[0]:.3g}, grad {errs[1]:.3g} of max|g|")
                worst = tuple(max(a, c) for a, c in zip(worst, errs))
            again = fn(x, y, emd._LEVELS, True, True)
            if not all(torch.equal(a, c) for a, c in zip(again, full)):
                fail(f"{name}'s second run differs from its first at {shape}")
            outs[name] = full
            print(f"kernel check {name} {shape}: cost rel {worst[0]:.3g} (tol "
                  f"{EMD_COST_RTOL}), grads {worst[1]:.3g} of max|g| (tol "
                  f"{EMD_GRAD_REL}), value-only cost bit-equal, second run bit-equal")
            if not (b in (50, EMD_ATTACK_PAIRS) and n == (1024 if name == "K6" else N_POINTS)):
                continue
            wrapper = fn.__name__
            ms = sync_timed(lambda: fn(x, y, emd._LEVELS, True, False), 10)
            record = {"max_abs_err": worst[2], "ms": ms, "bnm": (b, n, m)}
            note = ""
            if name == "K7":
                record["zero_share"] = zero_shares(emd, cu_emd, x, y)
                counts = torch.zeros(len(emd._LEVELS), 3, dtype=torch.int64, device="cuda")
                fn(x, y, emd._LEVELS, True, False, skip_counts=counts)
                pairs = torch.tensor([b * -(-m // 32) * n, b * -(-n // 32) * m,
                                      b * -(-n // 32) * m], dtype=torch.float64)
                skipped = (counts.cpu().double() / pairs).numpy().round(4).tolist()
                note = (f"; (warp, element) pairs skipped by level {emd._LEVELS} "
                        f"(column, row closing, row opening sweeps): {skipped}; pairs "
                        f"whose kernel value is +0: {[round(z, 4) for z in record['zero_share']]}")
            bound_ms = kernel_bound(wrapper, b, n, m, zero_share=record.get("zero_share"))[0]
            print(f"  {wrapper} at {shape}, g1 only: kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%){note}")
            if b == 50:
                record["plain_ms"] = sync_timed(
                    lambda: emd.emd_sweep_plain(x, y, True, False), 3)
                print(f"  plain sweep at {shape}, g1 only: {record['plain_ms']:.4f} ms")
                records[wrapper] = record
        if len(outs) == 2:
            errs = sweep_errors(outs["K6"], outs["K7"])
            if not (errs[0] <= EMD_COST_RTOL and errs[1] <= EMD_GRAD_REL):
                fail(f"K6 and K7 disagree at {shape}: {errs}")
            print(f"  K6 vs K7 at {shape}: cost rel {errs[0]:.3g}, grads "
                  f"{errs[1]:.3g} of max|g|")
        del x, y, want, outs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return records


def zero_shares(emd, cu_emd, x, y):
    """Per level, the share of the [b, n, m] pairs whose kernel value
    exp(level * d2) is exactly +0 (level * d2 below EXP_UNDERFLOW): the
    terms the function does not need, which K7's bound leaves out."""
    shares = []
    with torch.no_grad():
        for k in range(x.shape[0]):
            sqd = emd._sqdist_planes(x[k:k + 1], y[k:k + 1])
            shares.append([float((level * sqd < cu_emd.EXP_UNDERFLOW).double().mean())
                           for level in emd._LEVELS])
    return np.mean(shares, axis=0).tolist()


def run_stages(stages):
    """Run (name, main, argv) stages; returns per-stage (seconds, result)."""
    out = {}
    for name, fn, argv in stages:
        t0 = time.time()
        result = fn(argv)
        torch.cuda.synchronize()
        out[name] = (time.time() - t0, result)
        print(f"stage {name}: {out[name][0]:.2f} s")
    return out


def leg(name, counters, fn, required):
    """Zero every launch count, run ``fn``, read the counts: each kernel in
    ``required`` must have launched. Returns (counts, fn's result)."""
    for mod in counters:
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    counts = {}
    for mod in counters:
        counts.update(mod.launch_counts())
    print(f"leg {name}: launches {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for kernel in required:
        if counts[kernel] <= 0:
            fail(f"{kernel} was not launched in the {name} leg")
    return counts, result


def train_stage(project, ae, data, n_points, loss, epochs):
    from geometric_adv_tpu_torch.cli import train_ae

    return ("train_ae", train_ae.main,
            ["--project_dir", project, "--device", "cuda", "--data_folder", data,
             "--n_points", str(n_points), "--loss", loss, "--batch_size", "50",
             "--training_epochs", str(epochs), "--train_folder", ae])


def attack_stage(project, ae, iters, out="attack_res", flags=()):
    """run_attack on the card: 4 sources x 6 targets per class, ``iters``
    (iterations, threshold), artifacts under eval/``out``."""
    from geometric_adv_tpu_torch.cli import run_attack

    return ("run_attack", run_attack.main,
            ["--project_dir", project, "--device", "cuda", "--ae_folder", ae,
             "--attack_pc_idx", f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy",
             "--num_pc_for_attack", "4", "--num_pc_for_target", "2",
             "--num_iterations", str(iters[0]),
             "--num_iterations_thresh", str(iters[1]),
             "--output_folder_name", out, *flags])


def attack_stages(project, ae, data, iters):
    from geometric_adv_tpu_torch.cli import evaluate_attack, get_dists_per_point
    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack, tst_ae

    sel = f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy"
    common = ["--project_dir", project]
    dev = ["--device", "cuda"]
    return [
        ("tst_ae", tst_ae.main,
         common + dev + ["--data_folder", data, "--train_folder", ae]),
        ("prepare_indices_for_attack", prepare_indices_for_attack.main,
         common + dev + ["--ae_folder", ae, "--get_rand_idx", "1",
                         "--get_latent_nn_idx", "1", "--get_chamfer_nn_idx", "1",
                         "--num_instance_per_class", "4"]),
        attack_stage(project, ae, iters),
        ("get_dists_per_point", get_dists_per_point.main,
         common + dev + ["--ae_folder", ae, "--attack_pc_idx", sel]),
        ("evaluate_attack", evaluate_attack.main,
         common + ["--ae_folder", ae, "--attack_pc_idx", sel]),
    ]


def check_training(project, ae, epochs, stage, n_train=4 * 51, batch=50):
    """The loss in train_stats.txt falls from the first epoch to the last;
    returns samples/s over the epochs after the first (the trainer's own
    epoch times, synchronised by its per-epoch loss read)."""
    seconds, stats = stage
    lines = open(osp.join(project, ae, "train_stats.txt")).read().splitlines()
    rows = [ln.split("\t") for ln in lines if not ln.startswith("On Held_Out")]
    if [int(r[0]) for r in rows] != list(range(1, epochs + 1)):
        fail(f"{ae}/train_stats.txt has epochs {[r[0] for r in rows]}")
    losses = [float(r[1]) for r in rows]
    per_epoch = (n_train // batch) * batch
    rate = (epochs - 1) * per_epoch / sum(s[2] for s in stats[1:])
    print(f"training {ae}: loss by epoch {losses}; {rate:.1f} samples/s over "
          f"epochs 2-{epochs} ({per_epoch} per epoch); first epoch "
          f"{stats[0][2]:.3f} s, stage {seconds:.2f} s")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"the training loss of {ae} did not fall: {losses}")
    return rate


def check_artifacts(project, ae, n_classes, n_test, n_points, bneck=128):
    """Shapes of the JAX stages' artifacts, all finite."""
    ev = osp.join(project, ae, "eval")
    pairs = 4 * (n_classes - 1) * 2
    want = {
        "point_clouds_test_set_13l.npy": (n_test, n_points, 3),
        "latent_vectors_test_set_13l.npy": (n_test, bneck),
        "reconstructions_test_set_13l.npy": (n_test, n_points, 3),
        "ae_loss_test_set_13l.npy": (n_test,),
        "slice_idx_test_set_13l.npy": (n_classes + 1,),
        "pc_label_test_set_13l.npy": (n_test,),
        "pc_classes_13l.npy": (n_classes,),
    }
    if osp.exists(osp.join(ev, "attack_res")):
        want.update({
            "sel_idx_rand_4_test_set_13l.npy": (n_classes, 4),
            "latent_nn_idx_test_set_13l.npy": (n_test, n_test),
            "chamfer_dist_mat_complete_test_set_13l.npy": (n_test, n_test),
            "chamfer_nn_idx_complete_test_set_13l.npy": (n_test, n_test),
        })
        for c in CLASSES:
            want.update({
                f"attack_res/{c}/adversarial_metrics.npy": (1, pairs, 5),
                f"attack_res/{c}/adversarial_pc_input.npy": (1, pairs, n_points, 3),
                f"attack_res/{c}/adversarial_pc_recon.npy": (1, pairs, n_points, 3),
                f"attack_res/{c}/adversarial_pc_input_dists.npy": (1, pairs, n_points),
                f"attack_res/{c}/dist_weight.npy": (1,),
                f"attack_res/{c}/analysis_results/source_target_norm_min_idx.npy":
                    (pairs,),
            })
        stats = open(osp.join(ev, "attack_res/over_classes/eval_stats.txt")).read()
        if "over classes" not in stats or "S-CD" not in stats:
            fail(f"{ae} eval_stats.txt is incomplete")
    for rel, shape in want.items():
        a = np.load(osp.join(ev, rel))
        if a.shape != shape:
            fail(f"{ae}/eval/{rel}: shape {a.shape}, expected {shape}")
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            fail(f"{ae}/eval/{rel}: non-finite values")
    print(f"artifacts of {ae}: {len(want)} checked (shapes, finite)")


def check_attack_effect(project, ae, attack_folder="attack_res"):
    """Mean best T-RE of the attack vs the mean T-RE of the clean sources
    against the same targets, in the victim's own loss; prints the routing
    the run recorded in attack_impl.json."""
    from geometric_adv_tpu_torch.cli.common import AttackContext, restore_victim
    from geometric_adv_tpu_torch.train.trainer import reconstruction_loss_per_pc

    ctx = AttackContext(project, ae, attack_folder=attack_folder,
                        attack_pc_idx=f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy")
    victim = restore_victim(ctx.conf, ctx.ae_dir, "cuda")
    best, clean = [], []
    for _, name in ctx.classes_iter():
        src, tgt = ctx.class_attack_data(name, ctx.point_clouds)
        recon = victim.get_reconstructions(src)
        with torch.no_grad():
            clean.append(reconstruction_loss_per_pc(
                torch.from_numpy(recon).cuda(), torch.from_numpy(tgt).cuda(),
                ctx.conf.loss).cpu().numpy())
        m = np.load(osp.join(ctx.attack_dir, name, "adversarial_metrics.npy"))
        best.append(m[0, :, 4])
    best_mean = float(np.mean(np.concatenate(best)))
    clean_mean = float(np.mean(np.concatenate(clean)))
    impl = json.load(open(osp.join(ctx.attack_dir, "attack_impl.json")))
    print(f"attack effect ({ctx.conf.loss} victim, {attack_folder}, routing "
          f"{impl['attack_mode']}): mean best T-RE {best_mean:.6f} vs clean "
          f"sources {clean_mean:.6f}")
    if not best_mean < clean_mean:
        fail("the attack did not lower the mean target reconstruction error")
    return victim, impl


def check_attack_vs_host(victim, loss, pairs, iters, dist="chamfer",
                         columns=(0, 1, 2, 3, 4), card_kw=None, ref_kw=None,
                         ref_device="cpu"):
    """The attack on the card (kernels) against the same attack on the host
    CPU (plain versions), ``pairs`` x 2048 points at two dist weights;
    ``card_kw`` and ``ref_kw`` are attack_batch options of the two runs, and
    ``ref_device`` "cuda" holds two modes against each other on the card.
    Tolerance rtol 1e-3 / atol 1e-5 on the metric ``columns`` (loss_adv,
    loss_dist, S-CD, T-NRE, T-RE): the card's and the host's BLAS sum the
    victim's matmuls in different orders, and the Adam steps carry that
    difference forward. The other columns are printed."""
    import copy

    from geometric_adv_tpu_torch.attack.core import attack_batch

    rng = np.random.RandomState(7)
    x = rng.rand(pairs, N_POINTS, 3).astype(np.float32) - 0.5
    gt = rng.rand(pairs, N_POINTS, 3).astype(np.float32) - 0.5
    ref = np.ones(pairs, np.float32)
    pert0 = (rng.randn(pairs, N_POINTS, 3) * 1e-7).astype(np.float32)
    outs = {}
    ref_model = (victim.model if ref_device == "cuda"
                 else copy.deepcopy(victim.model).cpu())
    for name, dev, model, kw in (("card", "cuda", victim.model, card_kw or {}),
                                 ("ref", ref_device, ref_model, ref_kw or {})):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.no_grad():
            tz = model.encode(t(gt))
        outs[name] = attack_batch(
            model.encode, model.decode, t(x), tz, t(gt), t(ref), [1.0, 3.0],
            num_iterations=iters[0], num_iterations_thresh=iters[1],
            ae_loss_type=loss, loss_dist_type=dist, pert0=t(pert0), **kw,
        )
    err = np.abs(outs["card"].metrics - outs["ref"].metrics)
    lim = 1e-5 + 1e-3 * np.abs(outs["ref"].metrics)
    held = list(columns)
    rel = err / np.abs(outs["ref"].metrics)
    print(f"{loss} attack {card_kw or ''}, loss_dist_type {dist}, card vs "
          f"{'host' if ref_device == 'cpu' else 'card'} {ref_kw or ''} ({pairs} "
          f"pairs, {iters[0]} iterations): columns {held} max abs diff "
          f"{err[..., held].max():.3g}, max ratio to tolerance "
          f"{(err / lim)[..., held].max():.3g}; relative diff per column "
          f"{np.round(rel.max(axis=(0, 1)), 7).tolist()}")
    if not (err <= lim)[..., held].all():
        fail(f"the {loss} attack {card_kw or ''} on the card disagrees with "
             f"its reference run")


def attack_at_reference_batch(victim, label="exact", pairs=250, iters=20, **kw):
    """Attack pair-iterations/s at ``pairs`` pairs of 2048-point clouds (by
    default the reference's attack batch, 250), with the attack_batch
    options ``kw``, then a torch.profiler breakdown of 5 iterations: device
    time by kernel, the port's own kernels' share by source file, and the
    device's busy share of the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from geometric_adv_tpu_torch.attack.core import attack_batch

    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.rand(pairs, N_POINTS, 3).astype(np.float32) - 0.5).cuda()
    gt = torch.from_numpy(rng.rand(pairs, N_POINTS, 3).astype(np.float32) - 0.5).cuda()
    ref = torch.ones(pairs, device="cuda")
    model = victim.model
    with torch.no_grad():
        tz = model.encode(gt)

    def run(n_iter):
        return attack_batch(model.encode, model.decode, x, tz, gt, ref, [1.0],
                            num_iterations=n_iter, num_iterations_thresh=1, **kw)

    run(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    run(iters)
    torch.cuda.synchronize()
    rate = pairs * iters / (time.time() - t0)
    print(f"{label} attack at {pairs} pairs: {rate:.1f} pair-iters/s "
          f"({pairs} pairs x {N_POINTS} points, {iters} iterations)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(5)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    from torch.autograd import DeviceType

    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        print("profile: no device time recorded (not measured)")
        return rate
    print(f"profile of 5 {label} iterations: device busy {busy_us / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * busy_us / wall_us:.1f}%)")
    ranked = sorted(rows, key=lambda r: -r[1])
    # the eight largest, then the port's own kernels (csrc/, in anonymous
    # namespaces) below them
    own = [r for r in ranked[8:]
           if r[0].removeprefix("void ").startswith("(anonymous namespace)::")]
    for key, us, count in ranked[:8] + own:
        print(f"  {100 * us / busy_us:5.1f}%  {us / 1e3:8.3f} ms  x{count:<5d} "
              f"{key[:240]}")
    by_source = {}
    for key, us, _ in rows:
        for source, names in OWN_KERNELS.items():
            if any(f"namespace)::{k}" in key for k in names):
                by_source[source] = by_source.get(source, 0.0) + us
    print("  the port's own kernels by source: " + ", ".join(
        f"{src} {100 * us / busy_us:.1f}%" for src, us in sorted(by_source.items())))
    return rate


def chamfer_matrix_rate(project, data):
    from geometric_adv_tpu_torch.data.datasets import load_point_clouds_under_folder
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix

    clouds = np.concatenate([
        load_point_clouds_under_folder(osp.join(project, data, c)) for c in CLASSES
    ])
    chamfer_distance_matrix(clouds[:8], "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    chamfer_distance_matrix(clouds, "cuda")
    torch.cuda.synchronize()
    matrix_pairs = len(clouds) * (len(clouds) + 1) // 2
    rate = matrix_pairs / (time.time() - t0)
    print(f"chamfer matrix {rate:.1f} pair-evals/s ({matrix_pairs} pairs of "
          f"{N_POINTS}-point clouds)")
    return rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir
    from geometric_adv_tpu_torch.ops import chamfer as ch
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier
    from geometric_adv_tpu_torch.ops import emd
    from geometric_adv_tpu_torch.ops.cuda import build
    from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
    from geometric_adv_tpu_torch.ops.cuda import emd as cu_emd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    build.load_library()
    print(f"build: {time.time() - t0:.2f} s into {build.library_path()}")
    for ln in build.build_log.splitlines():
        if "Used" in ln or "Compiling entry" in ln:
            print(f"  {ln.strip()}")

    cu.reset_launch_counts()
    records = forward_kernel_phase(cu, ch)
    records.update(chamfer_kernel_phase(cu, ch))
    records.update(grad_kernel_phase(cu, ch))
    payload_kernel_phase(cu, ch)
    records.update(hier_kernel_phase(cu, hier, ch))
    # K4 and K8 are on no path of the package (as in the JAX package): their
    # launch counts are the kernel phase's
    phase_counts = cu.launch_counts()
    print(f"kernel phase launches: {phase_counts}")
    records.update(emd_kernel_phase(cu_emd, emd))

    shutil.rmtree(WORK, ignore_errors=True)
    project = WORK
    make_shapenet_like_dir(osp.join(project, "data/synthetic"), CLASSES,
                           n_per_class=60, n_points=N_POINTS, seed=0)
    make_shapenet_like_dir(osp.join(project, "data/synthetic_1024"), CLASSES,
                           n_per_class=60, n_points=1024, seed=1)
    n_test = 6 * len(CLASSES)  # the 85/5/10 split of 60 clouds: 51/3/6
    n_pairs = len(CLASSES) * 4 * (len(CLASSES) - 1) * 2
    counters = (cu, cu_emd)
    launches = dict.fromkeys(KERNELS, 0)
    rates = {}

    # --- chamfer leg --------------------------------------------------------
    ae = "log/autoencoder_victim"
    counts, stages = leg("chamfer", counters, lambda: run_stages(
        [train_stage(project, ae, "data/synthetic", N_POINTS, "chamfer", 2)]
        + attack_stages(project, ae, "data/synthetic", (500, 400))),
        ("nn_distance_cuda", "nn_distance_values_cuda", "chamfer_grad1_cuda"))
    launches = {k: launches[k] + counts[k] for k in launches}
    rates["chamfer train samples/s"] = check_training(project, ae, 2,
                                                      stages["train_ae"])
    check_artifacts(project, ae, len(CLASSES), n_test, N_POINTS)
    victim, impl = check_attack_effect(project, ae)
    calib_s = impl["calibration_seconds"]
    print(f"routing of the auto chamfer attack, as its calibration chose: "
          f"{impl['attack_mode']} (measured at {impl['batch_size']} pairs per "
          f"call, the attack's own batch, in {calib_s:.2f} s)")
    check_attack_vs_host(victim, "chamfer", 2, (30, 20))
    # the stage's wall clock without the runner's calibration
    seconds = stages["run_attack"][0] - calib_s
    rates["chamfer attack pair-iters/s"] = n_pairs * 500 / seconds
    print(f"chamfer attack {rates['chamfer attack pair-iters/s']:.1f} pair-iters/s "
          f"({n_pairs} pairs x 500 iterations in {seconds:.2f} s, stage wall "
          f"clock less the calibration's {calib_s:.2f} s)")
    rates["chamfer matrix pair-evals/s"] = chamfer_matrix_rate(project, "data/synthetic")
    rates["reference-batch attack pair-iters/s"] = attack_at_reference_batch(victim)
    del victim
    torch.cuda.synchronize()

    # --- frozen-assignment attack, refresh every 10 iterations (K5) ---------
    counts, stages = leg("frozen-10 attack", counters, lambda: run_stages([
        attack_stage(project, ae, (500, 400), "attack_res_frozen10",
                     ["--chamfer_refresh", "10"])]), ("chamfer_loss_payloads_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    # two chamfers x 51 chunks (501 steps, 50 of 10 and one of 1) x one
    # attack call per class (24 pairs each)
    schedule = 2 * -(-501 // 10) * len(CLASSES)
    if counts["chamfer_loss_payloads_cuda"] != schedule:
        fail(f"K5 ran {counts['chamfer_loss_payloads_cuda']} times in the frozen "
             f"attack, the refresh schedule is {schedule}")
    for k in ("nn_distance_cuda", "nn_distance_values_cuda", "chamfer_grad1_cuda"):
        if counts[k]:
            fail(f"{k} was launched in the frozen attack")
    print(f"frozen-10 attack: K5 launched {schedule} times, the refresh schedule; "
          "K1, K2, K3 not at all")
    victim, impl = check_attack_effect(project, ae, "attack_res_frozen10")
    if impl["attack_mode"] != "frozen-10":
        fail(f"the frozen attack recorded routing {impl['attack_mode']}")
    check_attack_vs_host(victim, "chamfer", 2, (30, 20),
                         card_kw=dict(chamfer_refresh=10),
                         ref_kw=dict(chamfer_refresh=10))
    check_attack_vs_host(victim, "chamfer", 2, (30, 20),
                         card_kw=dict(chamfer_refresh=1), ref_device="cuda")
    seconds = stages["run_attack"][0]
    rates["frozen-10 attack pair-iters/s"] = n_pairs * 500 / seconds
    print(f"frozen-10 attack {rates['frozen-10 attack pair-iters/s']:.1f} "
          f"pair-iters/s ({n_pairs} pairs x 500 iterations in {seconds:.2f} s, "
          "stage wall clock)")
    rates["frozen-10 reference-batch attack pair-iters/s"] = attack_at_reference_batch(
        victim, "frozen-10", chamfer_refresh=10)
    del victim
    torch.cuda.synchronize()

    # --- fused chamfer attack (K5 forward, elementwise backward) -----------
    counts, stages = leg("fused attack", counters, lambda: run_stages([
        attack_stage(project, ae, (500, 400), "attack_res_fused",
                     ["--chamfer_impl", "fused"])]), ("chamfer_loss_payloads_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    for k in ("nn_distance_cuda", "chamfer_grad1_cuda"):
        if counts[k]:
            fail(f"{k} was launched in the fused attack")
    victim, impl = check_attack_effect(project, ae, "attack_res_fused")
    if impl["attack_mode"] != "fused":
        fail(f"the fused attack recorded routing {impl['attack_mode']}")
    check_attack_vs_host(victim, "chamfer", 2, (30, 20),
                         card_kw=dict(chamfer_method="fused"),
                         ref_kw=dict(chamfer_method="fused"))
    seconds = stages["run_attack"][0]
    rates["fused attack pair-iters/s"] = n_pairs * 500 / seconds
    print(f"fused attack {rates['fused attack pair-iters/s']:.1f} pair-iters/s "
          f"({n_pairs} pairs x 500 iterations in {seconds:.2f} s, stage wall clock)")
    rates["fused reference-batch attack pair-iters/s"] = attack_at_reference_batch(
        victim, "fused", chamfer_method="fused")
    del victim
    torch.cuda.synchronize()

    # --- EMD leg at 2048 points ------------------------------------------------
    ae = "log/autoencoder_emd"
    print(f"EMD leg: run_attack cut to {EMD_ITERS[0]}/{EMD_ITERS[1]} iterations "
          "(the reference runs 500/400)")
    counts, stages = leg("EMD", counters, lambda: run_stages(
        [train_stage(project, ae, "data/synthetic", N_POINTS, "emd", 3)]
        + attack_stages(project, ae, "data/synthetic", EMD_ITERS)),
        ("emd_sweep_tiled_cuda", "nn_distance_values_cuda"))
    launches = {k: launches[k] + counts[k] for k in launches}
    rates["EMD train samples/s (2048)"] = check_training(project, ae, 3,
                                                         stages["train_ae"])
    check_artifacts(project, ae, len(CLASSES), n_test, N_POINTS)
    victim, _ = check_attack_effect(project, ae)
    # the EMD input distance's gradient, once the perturbation reaches the
    # point spacing, follows one-ulp differences (a one-ulp nudge of the
    # sources moved loss_dist by 6.3e-4 relative after 5 iterations on the
    # CPU), and Adam's early steps follow its signs: that attack holds the
    # target columns; the perturbation-norm distance holds every column
    check_attack_vs_host(victim, "emd", 1, (5, 3), dist="pert")
    check_attack_vs_host(victim, "emd", 1, (5, 3), columns=(0, 3, 4))
    seconds = stages["run_attack"][0]
    rates["EMD attack pair-iters/s"] = n_pairs * EMD_ITERS[0] / seconds
    print(f"EMD attack {rates['EMD attack pair-iters/s']:.1f} pair-iters/s "
          f"({n_pairs} pairs x {EMD_ITERS[0]} iterations in {seconds:.2f} s, "
          "stage wall clock)")
    rates["EMD attack pair-iters/s, 24 pairs in one call"] = attack_at_reference_batch(
        victim, "EMD", pairs=EMD_ATTACK_PAIRS, iters=10, ae_loss_type="emd")
    del victim
    torch.cuda.synchronize()

    # --- EMD at 1024 points (K6) ---------------------------------------------
    from geometric_adv_tpu_torch.cli import tst_ae

    ae = "log/autoencoder_emd_1024"
    data = "data/synthetic_1024"
    counts, stages = leg("EMD 1024", counters, lambda: run_stages([
        train_stage(project, ae, data, 1024, "emd", 2),
        ("tst_ae", tst_ae.main, ["--project_dir", project, "--device", "cuda",
                                 "--data_folder", data, "--train_folder", ae]),
    ]), ("emd_sweep_block_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    rates["EMD train samples/s (1024)"] = check_training(project, ae, 2,
                                                         stages["train_ae"])
    check_artifacts(project, ae, len(CLASSES), n_test, 1024)
    torch.cuda.synchronize()

    # --- chamfer at 1024 points: the fused loss (K5) in every train step ----
    ae = "log/autoencoder_chamfer_1024"
    counts, stages = leg("chamfer 1024", counters, lambda: run_stages([
        train_stage(project, ae, data, 1024, "chamfer", 2),
        ("tst_ae", tst_ae.main, ["--project_dir", project, "--device", "cuda",
                                 "--data_folder", data, "--train_folder", ae]),
    ]), ("chamfer_loss_payloads_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    rates["chamfer train samples/s (1024)"] = check_training(project, ae, 2,
                                                             stages["train_ae"])
    check_artifacts(project, ae, len(CLASSES), n_test, 1024)
    torch.cuda.synchronize()

    for k in ("chamfer_grad1_vpu_cuda", "nn_direction_hier_cuda"):
        launches[k] = phase_counts[k]
    print(f"launches over the six legs (K4, K8: the kernel phase's): {launches}")
    print("rates: " + json.dumps(rates))
    kernels = []
    for name, rec in records.items():
        b, n, m = rec.pop("bnm")
        bound_ms, bound_by, kind = kernel_bound(name, b, n, m, rec.pop("pairs", None),
                                                rec.pop("zero_share", None))
        rec.setdefault("ms_by", EVENT_TIME)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "shape": f"[{b},{n},3]x[{b},{m},3]", "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_type": kind, "library_ms": None, **rec})
        print(f"kernel {name} at [{b},{n},3]x[{b},{m},3]: {rec['ms']:.4f} ms "
              f"({rec['ms_by']}), bound "
              f"{bound_ms:.4f} ms ({kind}), {100 * bound_ms / rec['ms']:.1f}% of the bound; "
              f"{launches[name]} launches over the legs")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
