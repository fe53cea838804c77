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
     within 2.6e-6, K4 bit-equal to its plain version on the host (whose
     scatter sums run in ascending j, as K4's do), its second run bit-equal,
     within 2.6e-6 of K3; K4 timed as K3 is, by torch.profiler;
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
   - K8 and its preparation kernel (``nn_distance_hier``: one launch of
     each) on tie clouds and on the synthetic dataset's surface clouds at
     [64, 2048^2]: values bit-equal to K1, indices equal; on the surface
     clouds the preparation against the plain preparation (codes, order,
     sorted clouds, centres equal, radii within 1 ulp) and K8, both
     directions in one launch, bit-equal to its plain version; timed beside
     the op and K1, with the pairs its bound counts and the blocks an SM
     holds;
   - K6/K7 (the EMD sweep) at [24, 1024^2] and [50, 1024^2] (K6, K7 and
     each other: bit-equal),
     [24, 2048^2] and [50, 2048^2] (K7) and the ragged [8, 1024 x 512],
     [8, 500 x 1000]: cost rtol 1e-5, gradients atol 1e-4 * max|g|, in
     grads mode with and without g2 and value-only, whose cost must be
     bit-equal, second runs bit-equal; each timed at 24 and 50 pairs; the
     sweeps' numerics scanned on the card (expf is +0 exactly below their
     skip threshold, their square root from the gradient's rsqrt is
     sqrtf's), the share of (warp, element) pairs K7 skips at each level
     and K6's clusters resident at once printed;
   - the shapes of the evaluation legs: K2 at [1, 30000^2] (metro's: a
     block's rows outgrow its shared memory, the x2 loop runs 15 chunks)
     and [2, 5000 x 7000], bit-equal to its plain version in row chunks on
     the card; K1 and K3 at [16, 2500 x 2048] and [16, 2025 x 2048] (the
     AtlasNet and FoldingNet losses) on tie clouds, K1 bit-equal to its
     plain version, K3 to the host's ascending-j sums; second runs
     bit-equal; each timed beside its bound and plain version;
   - the fused train-mode batch norm + ReLU (``csrc/bn_relu.cu``, no TPU
     kernel: XLA fuses flax's BatchNorm) at the victim encoder's five
     layers, [50 x 2048, C] for C in 64, 128, 128, 256, 128, from ATen's
     batch moments: y, the statistics and the running statistics bit-equal
     to the plain version, dx, dweight and dbias within 1e-5 of each one's
     largest entry, second runs bit-equal; each wrapper's device time over
     the five layers beside its bytes at the card's memory rate and the
     plain version's;
4. the legs through the port's entry points on ``--device cuda``, each
   with the launch counts zeroed just before and read just after:
   - chamfer: ``train_ae --loss chamfer`` (2048 points, 2 epochs), tst_ae,
     prepare_indices_for_attack (all three index kinds), run_attack
     (500/400 iterations, routed by the runner's calibration),
     get_dists_per_point, evaluate_attack; K1, K2 and K3 must launch, and
     the fused batch norm + ReLU's forward and backward (train_ae);
   - defense, on that victim's attack: run_defense_critical (with its
     replay checks), evaluate_defense on its adversarial and clean-source
     results, get_knn_dists_per_point, run_defense_surface,
     evaluate_defense; the victim's loss kernel (K1) must launch, no EMD
     kernel may;
   - classifier, on that victim's data, attack and critical defense:
     train_classifier (2 epochs of batch 32), tst_classifier, run_classifier
     for the five data types and evaluate_classifier both ways; no chamfer
     or EMD kernel may launch;
   - correct-pred attack: run_attack ``--correct_pred_only 1 --chamfer_impl
     composed`` (20/10 iterations) on the labels train_classifier wrote; K1
     and K3 must launch;
   - transfer: train_transfer, tst_transfer, run_transfer, evaluate_transfer
     for AtlasNet (2500 points) and FoldingNet (2025 points), 2 epochs of
     batch 16, on that attack, then run_transfer with the victim as its own
     transfer AE and the 1e-6 identity replay; K1 and K3 must launch in
     both trainings, K5 and the EMD kernels never;
   - metro: train_transfer AtlasNet with the SQUARE template (2500 points),
     then run_metro over the four classes, 2 instances each, at 30000
     samples a side; K2 exactly once a mesh pair, nothing else;
   - binary search: ``binary_search_attack`` on 8 pairs, 3 steps of 50
     iterations; the attack's chamfer kernels (K1 and K3) must launch;
   - traced attack: run_attack ``--trace_dir`` (20/10 iterations,
     ``--chamfer_impl composed``); K1 and K3 must launch;
   - frozen-10: run_attack ``--chamfer_refresh 10`` on the same victim; K5
     must launch exactly on the refresh schedule, K1, K2, K3 never;
   - fused: run_attack ``--chamfer_impl fused``; K5 must launch, K1 and K3
     never;
   - latent-space attack: run_attack as runner_pipeline's latent stage runs
     it (``--loss_adv_type latent --dist_weight_list 150.0``, into
     latent_space_attack; cut to 20/10 iterations and 6 pairs a class,
     ``--chamfer_impl composed``), get_dists_per_point and evaluate_attack
     on it; K1 and K3 must launch;
   - the native PLY loader over the written tree beside the python parser
     (the chamfer leg's datasets must all have been parsed natively);
   - mesh: two ranks of this script (``--mesh-rank``) on the one card,
     started with the GAT_ variables (gloo; each prints its device and
     backend): run_attack ``--chamfer_impl composed`` (100/80 iterations,
     48 pairs a call, 24 a rank) against one rank at calls of 24, then the
     chamfer matrix over the dataset's 240 clouds and get_reconstructions /
     get_pre_symmetry_argmax under the mesh; K1 and K3 must launch on both
     ranks in the attack and K2 in the matrix; a rank that exits non-zero
     or outlasts its timeout fails the run;
   - mesh training: the mesh leg's processes then run ``train_ae``
     (chamfer at 2048 points, 2 epochs at learning rate 5e-5; EMD at 1024,
     1 epoch at the default 5e-4; full width, batch 50), as the two ranks
     and as the one process; each rank must report gloo as its device backend (the ranks share
     cuda:0) and launch the one process's kernels, K1 and K3 (chamfer) and
     K6 (EMD) among them; then, in the one process, the leg's chamfer
     training in process as is (equal to train_ae's, bit for bit) and on
     inputs one ulp up, at 5e-5 and 5e-4, and the NCCL phase: a one-rank
     NCCL group on the card through ``all_reduce_sum`` and the
     differentiable all-reduce, forward and backward;
   - sparse and dense encoder VJP: run_attack ``--encoder_vjp sparse`` and
     ``dense`` (``--chamfer_impl composed``, 100/80 iterations, 24 pairs a
     call), each a leg (K1 and K3 must launch, the sparse backward exactly
     once an iteration in the sparse leg and never in the dense one), then
     both at 250 pairs in one call;
   - precision: tst_ae and a 20/10 attack (composed) in float32, at
     ``--matmul_precision tensorfloat32`` and on the victim's weights in
     bfloat16 (``ae_dtype``), each a leg (K1 and K3 must launch; the TF32
     flags are off after each);
   - import: a reference-named victim at the full width mapped and written
     by the importer's functions, with its configuration from a reference
     configuration.txt, then tst_ae, prepare_indices_for_attack and a 20/10
     attack on it (K1 and K3 must launch); reference-layout AtlasNet and
     FoldingNet checkpoints imported by ``import_reference_ckpt`` and
     restored by tst_transfer; the CLI's TF branch;
   - ``verify_cuda`` as a stage (its launches compare kernels with their
     plain versions and are not counted);
   - EMD: ``train_ae --loss emd`` (2048 points, batch 50, 3 epochs), then the
     same stages with run_attack cut to 100/80 iterations; K7 and K2 must
     launch;
   - EMD at 1024 points: ``train_ae --loss emd --n_points 1024`` (2
     epochs); K6 must launch;
   - EMD attack at 1024 points: the stages after training on that victim,
     run_attack cut to 100/80 iterations; K6 must launch in run_attack, K7
     never there;
   - chamfer at 1024 points: ``train_ae --loss chamfer --n_points 1024``
     (2 epochs) and tst_ae; K5 (the fused loss) must launch;
   - pipeline: ``python3 -m geometric_adv_tpu_torch.runner_pipeline quick``
     in build/chip_smoke/pipeline/, its own 30 processes on its own
     dataset (4 classes x 30 clouds at 512 points); each stage reports its
     launches at its exit: K5 in train_ae, K1 and K3 or K5 in both attacks,
     K2 in prepare_indices_for_attack and run_metro;
   all on a synthetic dataset of sphere, cube, torus and cone, 60 clouds each;
5. output checks per leg: every artifact has the JAX stages' shape and is
   finite (the defenses' dtypes too), the training loss falls, each attack
   lowers the mean target
   reconstruction error, and each attack on the card agrees with the same
   attack on the host CPU (plain versions) on a small input: all metrics for
   chamfer (exact, frozen-10 and fused), and for the EMD victim with the
   perturbation-norm distance; the target-reconstruction metrics with the
   EMD distance (both EMD victims); the frozen attack refreshed every step
   agrees with the exact one on the card; the critical indices equal those
   of the card's argmax on the same adversarial inputs, the host's argmax
   equals the card's except at near-ties (each printed with its margin),
   the first class's kNN distances bit-equal to the host's; the chunk-screened
   chamfer matrix (C = 64, k = 8) over the exact matrix's clouds majorizes
   it, keeps each cloud's per-class nearest neighbour for at least 95% of
   the (cloud, class) pairs and at k = C equals it on one class; the
   binary search's weights stay within their bounds and its best distances
   at or below its first step's; the trace names K1's and K3's kernels;
   the sparse encoder VJP's z bit-equal to dense's and its gradient within
   2e-5 of the largest entry at [24, 2048] (mask flips printed), its attack
   within rtol 2e-4 / atol 1e-6 of dense on 2 pairs over 30 iterations (the
   100-iteration drift printed beside that of sources one ulp up); the
   imported victim's reconstructions within rtol 1e-5 / atol 1e-5 of the
   host's, the imported transfer AEs' test losses finite, the TF branch's
   ImportError; every verify_cuda check passed;
   the eval forward's batch invariance on the chamfer and EMD victims
   (get_reconstructions and get_loss_per_pc on 12 clouds at once against
   rows of 4, and three clouds in batches of 1-40, at 0; the plain
   forward's drift printed); the mesh leg's attack artifacts against the
   one-rank run at rtol 1e-5 / atol 1e-6, its matrix against one process
   at rtol 1e-5 / atol 1e-7, its reconstructions at rtol 1e-5 / atol 1e-6
   and argmax equal, every rank holding the same values; the mesh
   training's per-epoch losses against the one process at rtol 1e-5, every
   rank's parameters, BN statistics and Adam moments rank 0's bit for bit
   (a checksum per tensor), the restored checkpoints on 8 test clouds at
   atol 5e-3 (loss rtol 5e-3), train_stats.txt written once, and the NCCL
   phase's outputs equal to its inputs;
   the classifier's test-set labels recomputed on the host equal the
   card's except at near-ties (each printed with its margin), its label and
   eval_stats artifacts complete; each transfer AE's artifacts of the JAX
   stages' shapes, finite, and the first class's T-RE recomputed on the
   host within rtol 2e-4; every metro distance, rebuilt from the same
   instances and seeded samples, equal through K2 and on the host's chunked
   plain route to run_metro's; the latent-space attack's class means of
   each metric column within 3% of the same stage's on the host (plain
   versions, the same seeded initial perturbation), the bar proven both
   ways in the run (six perturbations of the sources move the card's own
   means less, a planted distance-weight fault moves them more), and its
   reconstructions within the attack's cloud bar (1e-5) in every pair
   where no critical point of the max-pool parts card and host; the share
   of entries within the attack's own bars (metrics rtol 2e-4 / atol
   1e-6, clouds atol 1e-5), which float32 noise already exceeds at full
   width, printed beside the perturbations'; the start-up of an idle
   stage's process (interpreter, torch, CUDA context, cli/common); the
   pipeline's 30 exit codes 0 and ``PIPELINE COMPLETE``, every artifact of
   ``runner_pipeline.check_artifacts`` with the JAX stages' shape, and the
   identity transfer's sanity checks passed for each class;
6. rates: train samples/s per leg, attack pair-iterations/s of every attack
   leg and, for the exact, frozen-10 and fused chamfer attacks, at the
   reference's batch of 250 pairs and for the EMD attacks (2048 and 1024
   points) at their 24 pairs per call (each with a torch.profiler breakdown
   and the port's kernels' share by source), the chamfer matrix's
   pair-evaluations/s, exact and screened, each defense stage's wall clock,
   ``knn_point`` at [100, 2048^2], the classifier's train samples/s and
   inference clouds/s at batch 250, AtlasNet's and FoldingNet's train
   samples/s, ``knn_point``'s share of a FoldingNet step (with its
   profile), metro's seconds a mesh pair, the native loader's and the
   python parser's seconds, the sparse and dense attacks' pair-iters/s (24
   pairs a call, 250 in one call, with profiles and peak memory), the
   float32, TF32 and bfloat16 victims' tst_ae seconds and attack rates with
   their deviation from float32, the blocked and plain eval forward's time
   over 240 clouds, the 2-rank against the 1-rank attack's wall, the mesh
   training's 2-rank and 1-process walls and samples/s, one ulp's move of
   one process's chamfer losses at both learning rates, the pipeline's
   stage walls, peak memory and launches, and the peak device memory of
   each leg.

Its last lines are a JSON record of the kernels (each with its shape, its
time and how it was taken (``ms_by``), the plain version's, its bound and
what sets it, and its launches over the legs), the card as nvidia-smi
reports it, and
``{"ok": true, "device": {...}}``. It writes only under
``build/`` in the checkout.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from geometric_adv_tpu_torch.cli.verify_cuda import tie_clouds
from geometric_adv_tpu_torch.ops.cuda.timing import (
    BN_ROWS, BN_WIDTHS, FP32_PEAK, FP64_PEAK, HBM_RATE, device_timed, sync_timed)

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
# the screened chamfer matrix's operating point (PARITY #14) and its bar on
# the per-class nearest neighbour (PARITY #14 measured 1.00 on 48 clouds)
SCREEN_C, SCREEN_K, SCREEN_TOP1 = 64, 8, 0.95
# a channel's argmax may differ between the card and the host where the
# card's point is within this share of the host's maximum on the host: the
# two GEMMs' roundings over 256-long dot products (~sqrt(256) * 2^-24)
NEAR_TIE = 1e-6
# the shapes the transfer and metro legs give the kernels: AtlasNet's and
# FoldingNet's losses (K1, K3), metro's Hausdorff at the default 30000 samples
# a side and a ragged pair (K2); the plain K2 runs in row chunks of PLAIN_CHUNK
TRANSFER_POINTS = {"atlasnet": 2500, "foldingnet": 2025}  # the decoders' outputs
TRANSFER_SHAPES = tuple((16, n, N_POINTS) for n in TRANSFER_POINTS.values())
METRO_SHAPES = ((1, 30000, 30000), (2, 5000, 7000))
PLAIN_CHUNK = 2048
METRO_FOLDER, METRO_PER_CLASS, METRO_SAMPLES = "log/atlasnet_square", 2, 30000
CLS_DATA_TYPES = ("target", "adversarial", "source", "before_defense", "after_defense")
# a test cloud's label may differ between the card and the host where the
# host's margin between its top logit and the card's label's is within this
# share of the cloud's largest |logit| (the two BLAS round differently)
CLS_NEAR_TIE = 1e-4
# what a record's "ms" is: a call's time by CUDA events around back-to-back
# calls, or, for K3 (shorter than its wrapper's host time), the kernel's own
# time on the device
EVENT_TIME = "CUDA events per call"
DEVICE_TIME = "torch.profiler device time per call"
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
    # K8's preparation: the JAX package's is jnp (morton_codes, sort_cloud,
    # build_block_structure), reached by no pallas_call
    "hier_prep_cuda": (CSRC + "nn_hier.cu", PALLAS + "chamfer_hier_kernel.py:104"),
    "emd_sweep_block_cuda": (CSRC + "emd_sweep.cu", PALLAS + "emd_fused_kernel.py:179"),
    "emd_sweep_tiled_cuda": (CSRC + "emd_sweep.cu", PALLAS + "emd_round_kernel.py:268"),
    # the fused train-mode batch norm + ReLU: the JAX package has none, XLA
    # fuses flax's BatchNorm (models/layers.py), reached by no pallas_call
    "bn_relu_forward_cuda": (CSRC + "bn_relu.cu", "none (XLA-fused BatchNorm + relu)"),
    "bn_relu_backward_cuda": (CSRC + "bn_relu.cu", "none (XLA-fused BatchNorm + relu)"),
}


# the port's own kernel functions by source, for the profiles' shares
OWN_KERNELS = {
    "nn_distance.cu (K1, K2)": ("nn_kernel",),
    "chamfer_grad.cu (K3, K4)": ("grad1_kernel",),
    "chamfer_payloads.cu (K5's payload pass)": ("payload_kernel",),
    "emd_sweep.cu (K6, K7)": ("emd_block_kernel", "tiled_"),
    "nn_hier.cu (K8)": ("hier_kernel",),
    "nn_hier.cu (K8's preparation)": ("hier_prep_kernel",),
    "bn_relu.cu (train-mode BN + ReLU)": ("bn_relu_forward_kernel", "bn_relu_grad_sums_kernel",
                                          "bn_relu_dx_kernel"),
}
# the fused batch norm + ReLU's backward against its plain version, of each
# output's largest entry (its sums run in another order); the forward and
# the running statistics bit-equal
BN_RELU_REL = 1e-5
# R x C float passes each wrapper's kernels move at least: the forward reads
# x and writes y (the batch moments are ATen's, before it); the backward reads
# dy and x for its two sums, then dy and x again and writes dx
BN_RELU_PASSES = {"bn_relu_forward_cuda": 2, "bn_relu_backward_cuda": 5}


def fail(msg: str):
    raise RuntimeError(msg)


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
    for K8, one minimum on the ``pairs`` of both directions that each
    query's own lower bounds leave, the least any exact search over its
    spheres scans; K8 reads the prepared clouds, 16 bytes a point, and its
    preparation, bound by its bytes, reads 12 and writes 16); per pair and level
    of the EMD sweep (g1 mode), 27 FP32 (the distance, the kernel value, the
    row, column and cost products and sums, the g1 terms) and 6 FP64 (its
    three float64 sums, product and add), but only the distance (8 FP32) for
    the ``zero_share`` of a level's pairs whose kernel value is exactly +0
    (K6 and K7 skip their terms); K3/K4 are O(n + m)."""
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
    elif name == "nn_direction_hier_cuda":  # both directions, prepared clouds
        fp32 = 9.0 * pairs
        nbytes = b * (n + m) * (16 + 8) + b * 16 * (-(-n // 128) + -(-m // 128))
    elif name == "hier_prep_cuda":  # both clouds; the sort's compares are few
        nbytes = b * (n + m) * (12 + 16) + b * 16 * (-(-n // 128) + -(-m // 128))
    else:  # the EMD sweeps, g1 only
        live = levels - sum(zero_share or ())
        fp32 = (8.0 * levels + 19.0 * live) * b * n * m
        fp64 = 6.0 * live * b * n * m
        nbytes = cloud + b * (4 + 12 * n)
    times = {"FP32": fp32 / FP32_PEAK, "FP64": fp64 / FP64_PEAK, "bytes": nbytes / HBM_RATE}
    kind = max(times, key=times.get)
    return times[kind] * 1e3, "bytes" if kind == "bytes" else "operations", kind


def chamfer_kernel_phase(cu, ch):
    """K1/K2/K3/K4 against their plain versions, K4 also against K3; K4
    bit-equal to its plain version on the host, whose scatter sums run in
    ascending j as K4's do (tests/test_torch_ops_chamfer_ties.py pins it to
    an explicit loop), and timed as K3 is, by its device time. Returns the
    record of K4 (K1 and K2 are timed in forward_kernel_phase, K3 in
    grad_kernel_phase)."""
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
            *(t.cpu() for t in (x1, x2, i1, i2, g1, g2)))
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
        k4_host = torch.equal(k4.cpu(), p4)
        k4_k3 = (k4 - k3).abs().max().item()
        k4_card = (k4 - p4_card).abs().max().item()
        again = cu.chamfer_grad1_vpu_cuda(x1, x2, i1, i2, g1, g2)
        print(f"kernel check {shape}: K1 values+indices bit-equal, K2 "
              f"bit-equal, K3 max abs err {k3_err:.3g}; K4 bit-equal to its plain "
              f"version on the host: {k4_host}, {k4_k3:.3g} from K3 (tol {GRAD_TOL}), "
              f"{k4_card:.3g} from its plain version on the card (atomic order)")
        if not (k4_host and torch.equal(again, k4)):
            fail(f"K4 differs from its plain version on the host or its first run at {shape}")
        if not k4_k3 <= GRAD_TOL:
            fail(f"K4 differs from K3 by {k4_k3} at {shape}")
        if n == m:  # time at the main-path shape
            args = (x1, x2, i1, i2, g1, g2)
            ms = device_timed(lambda: cu.chamfer_grad1_vpu_cuda(*args), 50)
            call_ms = sync_timed(lambda: cu.chamfer_grad1_vpu_cuda(*args), 50)
            plain_ms = sync_timed(lambda: ch.chamfer_grad1_vpu_plain(*args), 5)
            bound_ms = kernel_bound("chamfer_grad1_vpu_cuda", b, n, m)[0]
            records["chamfer_grad1_vpu_cuda"] = {
                "max_abs_err": 0.0, "ms": ms, "ms_by": DEVICE_TIME, "call_ms": call_ms,
                "plain_ms": plain_ms, "bnm": (b, n, m)}
            print(f"  chamfer_grad1_vpu_cuda at {shape}: {ms:.4f} ms on the device, "
                  f"{call_ms:.4f} ms a call by CUDA events; bound {bound_ms:.4f} ms "
                  f"({100 * bound_ms / ms:.1f}%); plain {plain_ms:.4f} ms")
        del x1, x2, d1, i1, d2, i2, r1, j1, r2, j2, v1, v2, k3, p3, k4, p4, p4_card, again
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


def hier_kernel_phase(cu, hier):
    """K8 and its preparation: ``nn_distance_hier`` (one launch of each)
    bit-equal to K1, values and indices, on tie clouds and surface clouds;
    on the surface clouds the preparation kernel against the plain
    preparation (codes, order and sorted cloud equal, centres equal, radii
    within 1 ulp) and K8, both directions in one launch, bit-equal to its
    plain version; each timed (CUDA events) beside the plain versions, the
    op and K1 at the same shape; the pairs K8's bound counts, the pairs its
    warps' votes need and those of a 128-query tile, and the blocks an SM
    holds, printed."""
    b = 64
    cases = {
        f"tie clouds [{b},{N_POINTS},3]^2": tie_clouds(b, N_POINTS, N_POINTS, seed=5),
        "tie clouds [16,2000,3]x[16,2048,3]": tie_clouds(16, 2000, N_POINTS, seed=6),
        f"surface clouds [{b},{N_POINTS},3]^2": surface_clouds(b, N_POINTS, seed=3),
    }
    for label, (x, y) in cases.items():
        before = cu.launch_counts()
        got = hier.nn_distance_hier(x, y)
        made = {k: v - before[k] for k, v in cu.launch_counts().items() if v != before[k]}
        want = cu.nn_distance_cuda(x, y)
        torch.cuda.synchronize()
        if made != {"hier_prep_cuda": 1, "nn_direction_hier_cuda": 1}:
            fail(f"nn_distance_hier launched {made} on the {label}, not one preparation "
                 "and one K8")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"nn_distance_hier differs from K1 on the {label}")
        print(f"kernel check K8 on the {label}: nn_distance_hier values bit-equal to K1, "
              f"indices equal; launches {made}")
    x, y = cases[f"surface clouds [{b},{N_POINTS},3]^2"]
    prepared = cu.hier_prep_cuda(x, y, with_codes=True)
    radius_err = 0.0
    for pts, (pts4, cyr, codes) in zip((x, y), prepared):
        want4, want_cyr = hier.prepare_plain(pts)
        ulp = torch.nextafter(want_cyr[..., 3], torch.tensor(np.inf, device="cuda"))
        radius_err = max(radius_err, (cyr[..., 3] - want_cyr[..., 3]).abs().max().item())
        if not (torch.equal(codes, hier.morton_codes(pts).to(torch.int32))
                and torch.equal(pts4, want4) and torch.equal(cyr[..., :3], want_cyr[..., :3])
                and bool(((cyr[..., 3] - want_cyr[..., 3]).abs()
                          <= ulp - want_cyr[..., 3]).all())):
            fail("the preparation kernel differs from the plain preparation")
    print("kernel check the preparation kernel on the surface clouds: codes, order, "
          f"sorted clouds and centres equal, radii within 1 ulp (max abs err {radius_err:.3g})")
    (x4, cyr_x, _), (y4, cyr_y, _) = prepared
    dirs = [(x4, y4, cyr_y), (y4, x4, cyr_x)]
    got = cu.nn_direction_hier_cuda(dirs)
    for (kd, ki), d in zip(got, dirs):
        pd, pi = hier.nn_direction_hier_plain(*d)
        torch.cuda.synchronize()
        if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
            fail("K8 differs from its plain version on the surface clouds")
    pairs = sum(hier_needed_pairs(hier, q, o4.shape[1], cyr, d[0])
                for (q, o4, cyr), d in zip(dirs, got))
    # device time (torch.profiler) as for K3: the preparation's wrapper takes
    # longer on the host than its kernel on the card (CUDA events printed)
    ms = device_timed(lambda: cu.nn_direction_hier_cuda(dirs), 20)
    call_ms = sync_timed(lambda: cu.nn_direction_hier_cuda(dirs), 20)
    one_ms = device_timed(lambda: cu.nn_direction_hier_cuda(dirs[:1]), 20)
    plain_ms = sync_timed(lambda: [hier.nn_direction_hier_plain(*d) for d in dirs], 3)
    prep_ms = device_timed(lambda: cu.hier_prep_cuda(x, y), 20)
    prep_call_ms = sync_timed(lambda: cu.hier_prep_cuda(x, y), 20)
    prep_plain_ms = sync_timed(lambda: [hier.prepare_plain(c) for c in (x, y)], 5)
    op_ms = sync_timed(lambda: hier.nn_distance_hier(x, y), 20)
    op_device_ms = device_timed(lambda: hier.nn_distance_hier(x, y), 20)
    k1_ms = sync_timed(lambda: cu.nn_distance_cuda(x, y), 20)
    tx, ty = cases[f"tie clouds [{b},{N_POINTS},3]^2"]
    tie_ms = sync_timed(lambda: hier.nn_distance_hier(tx, ty), 20)
    print(f"  nn_direction_hier_cuda on the prepared surface clouds: both directions "
          f"{ms:.4f} ms on the device in one launch ({call_ms:.4f} ms a call by CUDA "
          f"events), one direction {one_ms:.4f} ms (plain, both: {plain_ms:.4f} ms); "
          f"hier_prep_cuda, both clouds {prep_ms:.4f} ms on the device ({prep_call_ms:.4f} "
          f"ms a call; plain {prep_plain_ms:.4f} ms); nn_distance_hier {op_ms:.4f} ms a call, "
          f"{op_device_ms:.4f} ms on the device (uniform tie clouds {tie_ms:.4f} ms); K1 at "
          f"the same shape {k1_ms:.4f} ms")
    total = 2 * b * N_POINTS * N_POINTS
    votes = {nt: sum(hier_needed_pairs(hier, q, o4.shape[1], cyr, d[0], nt)
                     for (q, o4, cyr), d in zip(dirs, got)) for nt in (hier.NT, 128)}
    print(f"  K8's pairs, both directions, share of the {total} pairs: each query's own "
          f"(the bound) {pairs / total:.4f}; a warp's vote of {hier.NT} queries "
          f"{votes[hier.NT] / total:.4f}; a tile of 128 queries {votes[128] / total:.4f}; "
          f"{cu.hier_blocks_per_sm(N_POINTS)} K8 blocks an SM "
          "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    shape = (b, N_POINTS, N_POINTS)
    return {"nn_direction_hier_cuda": {"max_abs_err": 0.0, "ms": ms, "ms_by": DEVICE_TIME,
                                       "call_ms": call_ms, "plain_ms": plain_ms,
                                       "one_direction_ms": one_ms, "op_ms": op_ms,
                                       "op_device_ms": op_device_ms, "bnm": shape,
                                       "pairs": pairs},
            "hier_prep_cuda": {"max_abs_err": radius_err, "ms": prep_ms, "ms_by": DEVICE_TIME,
                               "call_ms": prep_call_ms, "plain_ms": prep_plain_ms,
                               "bnm": shape}}


def hier_needed_pairs(hier, q, m, cyr, d, tile=1):
    """Distance pairs of one direction that an exact search over these
    spheres must evaluate when a block is scanned for ``tile`` consecutive
    sorted queries at once: a block of sorted points is needed by a tile
    where some query's lower bound to its sphere (the kernel's formula) is
    at most that query's final NN distance ``d`` (in original order); each
    such (tile, block) costs the tile's queries x the block's points (of
    the other cloud's m). With tile 1, each query's own need: the least any
    exact search scans."""
    b, n, _ = q.shape
    nb = int(cyr.shape[1])
    d_sorted = torch.gather(d, 1, hier.cloud_ids(q).long())
    need = hier.lower_bounds(q[..., :3].contiguous(), cyr) <= d_sorted[..., None]
    tiles = -(-n // tile)
    need = torch.nn.functional.pad(need, (0, 0, 0, tiles * tile - n))
    need = need.reshape(b, tiles, tile, nb).any(dim=2).double()
    queries = torch.tensor([min(tile, n - t * tile) for t in range(tiles)],
                           dtype=torch.float64, device=q.device)
    points = torch.tensor([min(hier.BS, m - j * hier.BS) for j in range(nb)],
                          dtype=torch.float64, device=q.device)
    return float((need * queries[:, None] * points).sum().item())


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
    bit-equal to grads mode; second runs bit-equal; K6 bit-equal to K7
    (the same gradient sums in the same order; the per-row costs added in
    float64 in different orders, then rounded to float32); the numerics
    both rest on, checked on the card (``numerics_scan``: expf's underflow
    threshold, the square root from rsqrt); times at the main path's shapes,
    each sweep at the EMD attack's 24 pairs and the trainer's 50 (K6 and K7
    at 1024^2, K7 at 2048^2; mean of 10 kernel calls and 3 plain calls) in
    the attack's mode, g1 only, beside its bound and the share of (warp,
    element) pairs K7 skips at each level; K6's cluster and how many the
    card holds at once."""
    scan = cu_emd.numerics_scan(torch.device("cuda"))
    print(f"kernel check the EMD sweeps' numerics on the card: {scan}")
    if (scan["expf_mismatches"] or scan["sqrt_mismatches"]
            or scan["most_negative_positive"] != cu_emd.EXP_UNDERFLOW):
        fail(f"the EMD sweeps' numerics do not hold on this card: {scan}")
    for n, m in ((1024, 1024), (1024, 512), (500, 1000), (128, 128)):
        for flags in ((True, False), (True, True)):
            blocks, clusters = cu_emd.block_clusters(n, m, *flags)
            print(f"  emd_sweep_block_cuda at {n} x {m} points, (g1, g2) {flags}: "
                  f"clusters of {blocks} blocks, {clusters} resident at once "
                  "(cudaOccupancyMaxActiveClusters)")
    kernels = {"K6": cu_emd.emd_sweep_block_cuda, "K7": cu_emd.emd_sweep_tiled_cuda}
    records = {}
    for b, n, m, names in ((8, 1024, 512, "K6 K7"), (8, 500, 1000, "K6 K7"),
                           (EMD_ATTACK_PAIRS, 1024, 1024, "K6 K7"),
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
            if not (b in (50, EMD_ATTACK_PAIRS) and n == m):
                continue
            wrapper = fn.__name__
            ms = sync_timed(lambda: fn(x, y, emd._LEVELS, True, False), 10)
            record = {"max_abs_err": worst[2], "ms": ms, "bnm": (b, n, m),
                      "zero_share": zero_shares(emd, cu_emd, x, y)}
            note = (f"; pairs whose kernel value is +0: "
                    f"{[round(z, 4) for z in record['zero_share']]}")
            if name == "K7":
                counts = torch.zeros(len(emd._LEVELS), 3, dtype=torch.int64, device="cuda")
                fn(x, y, emd._LEVELS, True, False, skip_counts=counts)
                pairs = torch.tensor([b * -(-m // 32) * n, b * -(-n // 32) * m,
                                      b * -(-n // 32) * m], dtype=torch.float64)
                skipped = (counts.cpu().double() / pairs).numpy().round(4).tolist()
                note += (f"; (warp, element) pairs skipped by level {emd._LEVELS} "
                         f"(column, row closing, row opening sweeps): {skipped}")
            bound_ms = kernel_bound(wrapper, b, n, m, zero_share=record.get("zero_share"))[0]
            print(f"  {wrapper} at {shape}, g1 only: kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%){note}")
            if b == 50 and (name == "K6" or n == N_POINTS):  # the JSON line's shapes
                record["plain_ms"] = sync_timed(
                    lambda: emd.emd_sweep_plain(x, y, True, False), 3)
                print(f"  plain sweep at {shape}, g1 only: {record['plain_ms']:.4f} ms")
                records[wrapper] = record
        if len(outs) == 2:
            errs = sweep_errors(outs["K6"], outs["K7"])
            same = [torch.equal(a, c) for a, c in zip(outs["K6"], outs["K7"])]
            print(f"  K6 vs K7 at {shape}: cost rel {errs[0]:.3g}, grads "
                  f"{errs[1]:.3g} of max|g|; bit-equal (cost, g1, g2): {same}")
            if not all(same):
                fail(f"K6 and K7 disagree at {shape}: {errs}, bit-equal {same}")
        del x, y, want, outs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return records


def bn_relu_kernel_phase(cu_bn, bn_op):
    """The fused train-mode batch norm + ReLU's wrappers against their plain
    versions at the victim encoder's five layers, [50 x 2048, C] for C in
    BN_WIDTHS, from the batch moments as BatchNorm takes them: y, the
    statistics and the running statistics bit-equal, dx, dweight and dbias
    within BN_RELU_REL of each output's largest entry, a second run
    bit-equal. Each wrapper's device time summed over the five layers (one
    training step; mean of 20 calls), against its bytes at HBM_RATE
    (BN_RELU_PASSES) and the plain version's device time."""
    from geometric_adv_tpu_torch.models.layers import BatchNorm

    records = {name: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "bound_ms": 0.0,
                      "ms_by": DEVICE_TIME,
                      "shape": f"[{BN_ROWS},C] for C in {list(BN_WIDTHS)}, a step"}
               for name in BN_RELU_PASSES}
    for layer, c in enumerate(BN_WIDTHS):
        bn = BatchNorm(c)  # the encoder's eps and momentum
        rng = np.random.RandomState(400 + layer)
        x, dy = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (
            rng.randn(BN_ROWS, c) * rng.uniform(0.2, 3.0, c) + rng.uniform(-2, 2, c),
            rng.randn(BN_ROWS, c)))
        w, b, rm, rv = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (
            rng.rand(c) + 0.5, rng.randn(c) * 0.3, rng.randn(c), rng.rand(c) + 0.5))
        mean, mean_sq = bn_op.batch_moments(x)
        runs = []
        for _ in range(2):
            rm_k, rv_k = rm.clone(), rv.clone()
            y, stats = cu_bn.bn_relu_forward_cuda(x, mean, mean_sq, w, b, rm_k, rv_k,
                                                  bn.eps, bn.momentum)
            runs.append((y, stats, rm_k, rv_k, *cu_bn.bn_relu_backward_cuda(dy, x, w, b, stats)))
        torch.cuda.synchronize()
        shape = f"[{BN_ROWS},{c}]"
        if not all(torch.equal(a, a2) for a, a2 in zip(*runs)):
            fail(f"bn_relu's second run differs from its first at {shape}")
        y, stats, rm_k, rv_k, *grads = runs[0]
        want_y, want_stats = bn_op.bn_relu_forward_plain(x, mean, mean_sq, w, b, bn.eps)
        want_rm, want_rv = rm.clone(), rv.clone()
        bn_op.update_running(want_rm, want_stats[0], bn.momentum)
        bn_op.update_running(want_rv, want_stats[1], bn.momentum)
        for got, want, name in ((y, want_y, "y"), (stats, want_stats, "stats"),
                                (rm_k, want_rm, "running mean"), (rv_k, want_rv, "running var")):
            if not torch.equal(got, want):
                fail(f"bn_relu_forward_cuda's {name} is not bit-equal to the plain "
                     f"version's at {shape}")
        rels = []
        for got, want, name in zip(grads, bn_op.bn_relu_backward_plain(dy, x, w, b, stats),
                                   ("dx", "dweight", "dbias")):
            err = (got - want).abs().max().item()
            rels.append(err / max(want.abs().max().item(), 1e-30))
            rec = records["bn_relu_backward_cuda"]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            if rels[-1] > BN_RELU_REL:
                fail(f"bn_relu_backward_cuda's {name} differs from the plain version at "
                     f"{shape}: {rels[-1]:.3g} of its largest entry")
        print(f"kernel check bn_relu at {shape}: y, stats and the running statistics "
              f"bit-equal to the plain version; dx, dweight, dbias "
              f"{[float(f'{r:.3g}') for r in rels]} of their largest entries (tol "
              f"{BN_RELU_REL}); second run bit-equal")
        calls = {"bn_relu_forward_cuda": (
                     lambda: cu_bn.bn_relu_forward_cuda(x, mean, mean_sq, w, b, rm_k, rv_k,
                                                        bn.eps, bn.momentum),
                     lambda: bn_op.bn_relu_forward_plain(x, mean, mean_sq, w, b, bn.eps)),
                 "bn_relu_backward_cuda": (
                     lambda: cu_bn.bn_relu_backward_cuda(dy, x, w, b, stats),
                     lambda: bn_op.bn_relu_backward_plain(dy, x, w, b, stats))}
        for name, (fn, plain) in calls.items():
            ms, plain_ms = device_timed(fn, 20), device_timed(plain, 20)
            bound_ms = BN_RELU_PASSES[name] * BN_ROWS * c * 4 / HBM_RATE * 1e3
            print(f"  {name} at {shape}: kernels {ms:.4f} ms (device), bound "
                  f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%), plain {plain_ms:.4f} ms")
            rec = records[name]
            rec["ms"] += ms
            rec["plain_ms"] += plain_ms
            rec["bound_ms"] += bound_ms
        del x, dy, runs, grads
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


def run_stages(stages, watch=()):
    """Run (name, main, argv) stages; returns per-stage (seconds, result,
    launches of each wrapper in ``watch`` during the stage)."""
    out = {}
    for name, fn, argv in stages:
        before = [w.launches for w in watch]
        t0 = time.time()
        result = fn(argv)
        torch.cuda.synchronize()
        made = {w.__name__: w.launches - b for w, b in zip(watch, before)}
        out[name] = (time.time() - t0, result, made)
        print(f"stage {name}: {out[name][0]:.2f} s" + (f"; launches {made}" if made else ""))
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
    seconds, stats = stage[:2]
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
                         ref_device="cpu", n_points=N_POINTS, card_encode=None,
                         tol=(1e-3, 1e-5)):
    """The attack on the card (kernels) against the same attack on the host
    CPU (plain versions), ``pairs`` x ``n_points`` points at two dist weights;
    ``card_kw`` and ``ref_kw`` are attack_batch options of the two runs,
    ``card_encode`` replaces the card run's encoder, and ``ref_device``
    "cuda" holds two modes against each other on the card. Tolerance
    ``tol`` (rtol, atol), by default 1e-3 / 1e-5, on the metric ``columns``
    (loss_adv, loss_dist, S-CD, T-NRE, T-RE): the card's and the host's BLAS
    sum the victim's matmuls in different orders, and the Adam steps carry
    that difference forward. The other columns are printed."""
    import copy

    from geometric_adv_tpu_torch.attack.core import attack_batch

    rng = np.random.RandomState(7)
    x = rng.rand(pairs, n_points, 3).astype(np.float32) - 0.5
    gt = rng.rand(pairs, n_points, 3).astype(np.float32) - 0.5
    ref = np.ones(pairs, np.float32)
    pert0 = (rng.randn(pairs, n_points, 3) * 1e-7).astype(np.float32)
    outs = {}
    ref_model = (victim.model if ref_device == "cuda"
                 else copy.deepcopy(victim.model).cpu())
    for name, dev, model, kw in (("card", "cuda", victim.model, card_kw or {}),
                                 ("ref", ref_device, ref_model, ref_kw or {})):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.no_grad():
            tz = model.encode(t(gt))
        encode = card_encode if name == "card" and card_encode else model.encode
        outs[name] = attack_batch(
            encode, model.decode, t(x), tz, t(gt), t(ref), [1.0, 3.0],
            num_iterations=iters[0], num_iterations_thresh=iters[1],
            ae_loss_type=loss, loss_dist_type=dist, pert0=t(pert0), **kw,
        )
    err = np.abs(outs["card"].metrics - outs["ref"].metrics)
    lim = tol[1] + tol[0] * np.abs(outs["ref"].metrics)
    held = list(columns)
    rel = err / np.abs(outs["ref"].metrics)
    print(f"{loss} attack {card_kw or ''}{' (sparse encoder VJP)' if card_encode else ''}, "
          f"loss_dist_type {dist}, tolerance {tol}, card vs "
          f"{'host' if ref_device == 'cpu' else 'card'} {ref_kw or ''} ({pairs} "
          f"pairs of {n_points} points, {iters[0]} iterations): columns {held} max abs diff "
          f"{err[..., held].max():.3g}, max ratio to tolerance "
          f"{(err / lim)[..., held].max():.3g}; relative diff per column "
          f"{np.round(rel.max(axis=(0, 1)), 7).tolist()}")
    if not (err <= lim)[..., held].all():
        fail(f"the {loss} attack {card_kw or ''} on the card disagrees with "
             f"its reference run")


def attack_at_reference_batch(victim, label="exact", pairs=250, iters=20,
                              n_points=N_POINTS, encode=None, **kw):
    """Attack pair-iterations/s at ``pairs`` pairs of ``n_points``-point
    clouds (by default the reference's attack batch, 250), with the attack_batch
    options ``kw`` (``encode`` replaces the victim's), then a torch.profiler breakdown of 5 iterations: device
    time by kernel, the port's own kernels' share by source file, and the
    device's busy share of the wall clock."""
    from torch.profiler import ProfilerActivity, profile

    from geometric_adv_tpu_torch.attack.core import attack_batch

    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.rand(pairs, n_points, 3).astype(np.float32) - 0.5).cuda()
    gt = torch.from_numpy(rng.rand(pairs, n_points, 3).astype(np.float32) - 0.5).cuda()
    ref = torch.ones(pairs, device="cuda")
    model = victim.model
    encode = encode or model.encode
    with torch.no_grad():
        tz = model.encode(gt)

    def run(n_iter):
        return attack_batch(encode, model.decode, x, tz, gt, ref, [1.0],
                            num_iterations=n_iter, num_iterations_thresh=1, **kw)

    run(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    run(iters)
    torch.cuda.synchronize()
    rate = pairs * iters / (time.time() - t0)
    print(f"{label} attack at {pairs} pairs: {rate:.1f} pair-iters/s "
          f"({pairs} pairs x {n_points} points, {iters} iterations)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(5)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    from torch.autograd import DeviceType

    # kernel rows only: an operator's row repeats its kernels' device time,
    # and so does the device row of a span of the program (a user annotation)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
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
    """The exact chamfer matrix over the dataset's clouds (K2): returns
    (pair-evals/s, the clouds, the matrix, the class slices)."""
    from geometric_adv_tpu_torch.data.datasets import load_point_clouds_under_folder
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix

    per_class = [load_point_clouds_under_folder(osp.join(project, data, c))
                 for c in CLASSES]
    clouds = np.concatenate(per_class)
    slice_idx = np.cumsum([0] + [len(c) for c in per_class])
    chamfer_distance_matrix(clouds[:8], "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    mat = chamfer_distance_matrix(clouds, "cuda")
    torch.cuda.synchronize()
    matrix_pairs = len(clouds) * (len(clouds) + 1) // 2
    rate = matrix_pairs / (time.time() - t0)
    print(f"chamfer matrix {rate:.1f} pair-evals/s ({matrix_pairs} pairs of "
          f"{N_POINTS}-point clouds)")
    return rate, clouds, mat, slice_idx


def screened_matrix_check(clouds, exact, exact_rate, slice_idx):
    """The chunk-screened matrix (PARITY #14) at C = SCREEN_C, k = SCREEN_K
    over the exact matrix's clouds, timed beside it: every entry >= the
    exact one, the per-class nearest neighbour of ``sort_dist_mat`` (the
    matrix job's consumer) the exact one's for at least SCREEN_TOP1 of the
    (cloud, class) pairs, and with k = C equal to the exact matrix at rtol
    1e-6 on the first class's clouds (all 240 at k = C would take 8x the
    screened run). Returns its pair-evals/s."""
    from geometric_adv_tpu_torch.attack.pipeline import sort_dist_mat
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix

    chamfer_distance_matrix(clouds[:8], "cuda", screen_chunks=SCREEN_C)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    scr = chamfer_distance_matrix(clouds, "cuda", screen_chunks=SCREEN_C,
                                  screen_k=SCREEN_K)
    torch.cuda.synchronize()
    pairs = len(clouds) * (len(clouds) + 1) // 2
    rate = pairs / (time.time() - t0)
    off = ~np.eye(len(clouds), dtype=bool)
    rel = (scr - exact)[off] / np.maximum(exact[off], 1e-12)
    nn_e = sort_dist_mat(exact.copy(), slice_idx)
    nn_s = sort_dist_mat(scr.copy(), slice_idx)
    heads = [nn_e[:, a] == nn_s[:, a] for a in slice_idx[:-1]]
    top1 = float(np.mean(heads))
    first = slice(0, int(slice_idx[1]))
    full = chamfer_distance_matrix(clouds[first], "cuda", screen_chunks=SCREEN_C,
                                   screen_k=SCREEN_C)
    full_err = float(np.max(np.abs(full - exact[first, first])
                            / np.maximum(np.abs(exact[first, first]), 1e-30)))
    print(f"screened chamfer matrix (C={SCREEN_C}, k={SCREEN_K}): {rate:.1f} pair-evals/s "
          f"beside the exact {exact_rate:.1f} ({pairs} pairs); entries over the exact: "
          f"mean relative {rel.mean():.4g}, max {rel.max():.4g}, {int((rel > 0).sum())} of "
          f"{rel.size} above it; per-class top-1 agreement {top1:.4f} (bar {SCREEN_TOP1}); "
          f"k = C on {first.stop} clouds: max relative difference {full_err:.3g} (bar 1e-6)")
    if not np.all(scr >= exact):
        fail("a screened chamfer-matrix entry is below its exact value")
    if not top1 >= SCREEN_TOP1:
        fail(f"the screened matrix's per-class top-1 agreement is {top1}")
    if not full_err <= 1e-6:
        fail(f"the screened matrix at k = C differs from the exact one by {full_err}")
    device_breakdown(lambda: chamfer_distance_matrix(
        clouds[:16], "cuda", screen_chunks=SCREEN_C, screen_k=SCREEN_K),
        "the screened matrix over 16 clouds (136 pairs, 2 blocks)")
    return rate


def defense_stages(project, ae):
    """The defense CLIs on the card after the attack's stages, in order."""
    from geometric_adv_tpu_torch.cli import (
        evaluate_defense,
        get_knn_dists_per_point,
        run_defense_critical,
        run_defense_surface,
    )

    a = ["--project_dir", project, "--ae_folder", ae,
         "--attack_pc_idx", f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy"]
    dev = ["--device", "cuda"]
    crit = ["--defense_folder", "defense_critical_res"]
    return [
        ("run_defense_critical", run_defense_critical.main,
         a + dev + ["--do_sanity_checks", "1"]),
        ("evaluate_defense critical", evaluate_defense.main, a + crit),
        ("evaluate_defense critical, clean sources", evaluate_defense.main,
         a + crit + ["--use_adversarial_data", "0"]),
        ("get_knn_dists_per_point", get_knn_dists_per_point.main, a + dev),
        ("run_defense_surface", run_defense_surface.main, a + dev),
        ("evaluate_defense surface", evaluate_defense.main,
         a + ["--defense_folder", "defense_surface_res"]),
    ]


def check_defense_artifacts(project, ae, n_points, bneck=128, knn=8):
    """The defense artifacts with the JAX CLIs' shapes and dtypes, floats
    finite, the defended S-RE finite, and the three eval_stats.txt."""
    res = osp.join(project, ae, "eval", "attack_res")
    pairs = 4 * (len(CLASSES) - 1) * 2
    f32, i16 = np.dtype(np.float32), np.dtype(np.int16)
    checked = 0
    for c in CLASSES:
        out_num = np.load(osp.join(res, "defense_surface_res", c,
                                   "adversarial_critical_num.npy"))
        out_max = max(int(out_num.max()), 1)
        for folder, wide in (("defense_critical_res", bneck),
                             ("defense_surface_res", out_max)):
            want = {
                f"{folder}/{c}/adversarial_critical_points.npy": ((1, pairs, wide, 3), f32),
                f"{folder}/{c}/adversarial_critical_idx.npy": ((1, pairs, wide), i16),
                f"{folder}/{c}/adversarial_critical_num.npy": ((1, pairs), i16),
                f"{folder}/{c}/defended_pc_input.npy": ((1, pairs, n_points, 3), f32),
                f"{folder}/{c}/defended_pc_recon.npy": ((1, pairs, n_points, 3), f32),
                f"{folder}/{c}/defense_metrics.npy": ((1, pairs, 4), f32),
                f"{folder}_orig/{c}/defended_source_input.npy": ((pairs, n_points, 3), f32),
                f"{folder}_orig/{c}/defended_source_recon.npy": ((pairs, n_points, 3), f32),
                f"{folder}_orig/{c}/defense_source_metrics.npy": ((pairs, 4), f32),
                f"{folder}_orig/{c}/original_critical_num.npy": ((pairs,), i16),
            }
            orig_wide = bneck if folder == "defense_critical_res" else n_points
            want[f"{folder}_orig/{c}/original_source_critical_points.npy"] = (
                (pairs, orig_wide, 3), f32)
            want[f"{folder}_orig/{c}/original_critical_idx.npy"] = ((pairs, orig_wide), i16)
            if folder == "defense_surface_res":
                want[f"{folder}/{c}/knn_dists_adversarial_pc_input.npy"] = (
                    (1, pairs, n_points, knn), f32)
                want[f"{folder}_orig/{c}/knn_dists_source_pc.npy"] = (
                    (pairs, n_points, knn), f32)
            for rel, (shape, dtype) in want.items():
                a = np.load(osp.join(res, rel))
                if a.shape != shape or a.dtype != dtype:
                    fail(f"{rel}: {a.shape} {a.dtype}, expected {shape} {dtype}")
                if dtype == f32 and not np.isfinite(a).all():
                    fail(f"{rel}: non-finite values")
            checked += len(want)
    for folder in ("defense_critical_res", "defense_critical_res_orig",
                   "defense_surface_res"):
        stats = open(osp.join(res, folder, "over_classes", "eval_stats.txt")).read()
        if "over classes" not in stats or "S-RE" not in stats:
            fail(f"{folder}/over_classes/eval_stats.txt is incomplete")
    print(f"defense artifacts of {ae}: {checked} checked (shapes, dtypes, finite "
          "values: the defended S-RE included) and 3 eval_stats.txt")


def check_defense_on_host(project, ae, victim):
    """The critical defense against the host. Per class, from the same
    adversarial inputs: the critical points of the card's per-channel
    argmax equal the artifacts (the numpy code on the same inputs), and the
    host CPU's argmax (the plain path) equals the card's except at near-ties,
    channels where the card's point is within NEAR_TIE of the host's
    maximum on the host (the two devices' GEMMs round differently); each
    such flip is printed with its margin. The first class's kNN distances on
    the host are bit-equal to the card's. Returns the critical defense's
    mean S-RE, defended and not, and the flips."""
    import copy

    from geometric_adv_tpu_torch.attack.pipeline import get_quantity_at_index
    from geometric_adv_tpu_torch.defense import (
        get_critical_pc_non_critical_pc,
        knn_dists_per_point,
    )

    host = copy.copy(victim)
    host.model = copy.deepcopy(victim.model).cpu()
    host.device = torch.device("cpu")
    res = osp.join(project, ae, "eval", "attack_res")
    sre, flips, channels = [], [], 0
    for k, c in enumerate(CLASSES):
        adv = np.load(osp.join(res, c, "adversarial_pc_input.npy"))
        best = np.load(osp.join(res, c, "analysis_results",
                                "source_target_norm_min_idx.npy"))
        adv = get_quantity_at_index([adv], best)
        card_idx, card_val = victim.get_pre_symmetry_argmax(adv)
        _, ci, cn, _, _ = get_critical_pc_non_critical_pc(
            adv, max_idx_all=card_idx, max_val_all=card_val)
        card_ci = np.load(osp.join(res, "defense_critical_res", c,
                                   "adversarial_critical_idx.npy"))[0]
        card_cn = np.load(osp.join(res, "defense_critical_res", c,
                                   "adversarial_critical_num.npy"))[0]
        if not (np.array_equal(ci, card_ci) and np.array_equal(cn, card_cn)):
            fail(f"the critical indices of {c} differ from its card's argmax's")
        host_idx, _ = host.get_pre_symmetry_argmax(adv)
        channels += host_idx.size
        pre = host.get_pre_symmetry_data(adv)
        for p, ch in np.argwhere(card_idx != host_idx):
            top = pre[p, host_idx[p, ch], ch]
            margin = float(top - pre[p, card_idx[p, ch], ch])
            flips.append(margin / abs(top))
            print(f"  argmax flip in {c}, cloud {p}, channel {ch}: host point "
                  f"{host_idx[p, ch]}, card point {card_idx[p, ch]}, host margin "
                  f"{margin:.3g} of {top:.6g}")
            if not margin <= NEAR_TIE * abs(top):
                fail(f"the card's argmax in {c} is not a near-tie on the host")
        metrics = np.load(osp.join(res, "defense_critical_res", c, "defense_metrics.npy"))
        sre.append(metrics[0, :, [0, 2]])
        if k == 0:
            knn_host = knn_dists_per_point(adv, "cpu")
            knn_card = np.load(osp.join(res, "defense_surface_res", c,
                                        "knn_dists_adversarial_pc_input.npy"))[0]
            if not np.array_equal(knn_host, knn_card):
                fail(f"the kNN distances of {c} on the card differ from the host's by "
                     f"{np.abs(knn_host - knn_card).max()}")
    sre = np.concatenate(sre, axis=1).mean(axis=1)
    print(f"defense checks on the host: the critical indices of {len(CLASSES)} classes equal "
          f"those of the card's argmax; the host's argmax equal to the card's on "
          f"{channels - len(flips)} of {channels} channels, the {len(flips)} others "
          f"near-ties (relative host margins {[float(f'{m:.3g}') for m in flips]}, bar "
          f"{NEAR_TIE}); {CLASSES[0]}'s kNN distances bit-equal; critical defense mean "
          f"S-RE {sre[0]:.6f} defended vs {sre[1]:.6f} undefended")
    return sre, flips


def device_breakdown(fn, label, top=6):
    """torch.profiler over one call of ``fn`` after a warm-up: its device
    time and the ``top`` kernels by device time. For the PyTorch
    compositions, whose kernels are the library's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])
    if not rows:
        print(f"profile of {label}: no device time recorded (not measured)")
        return
    busy = sum(r[1] for r in rows)
    print(f"profile of {label}: device time {busy / 1e3:.3f} ms")
    for key, us, count in rows[:top]:
        print(f"  {100 * us / busy:5.1f}%  {us / 1e3:8.3f} ms  x{count:<5d} {key[:160]}")


def knn_time(batch=100, k=9):
    """``knn_point`` at the defense's batch of ``batch`` 2048-point clouds,
    k + 1 = 9 against themselves (CUDA events around 3 calls), and its
    device time by kernel."""
    from geometric_adv_tpu_torch.ops.grouping import knn_point

    x = surface_clouds(batch, N_POINTS, seed=8)[0]
    knn_point(k, x[:4], x[:4])  # warm-up
    ms = sync_timed(lambda: knn_point(k, x, x), 3)
    print(f"knn_point at [{batch}, {N_POINTS}^2], k = {k}: {ms:.3f} ms a call")
    device_breakdown(lambda: knn_point(k, x, x), f"knn_point at [{batch}, {N_POINTS}^2]")
    return ms


def binary_search_check(project, ae, victim, counters, required, pairs=8,
                        steps=3, iters=50):
    """``binary_search_attack`` on ``pairs`` pairs of the first class's pair
    grid, ``steps`` steps of ``iters`` iterations, in a leg of its own
    (``required`` kernels must launch): finite outputs, final weights within
    [0, the upper bound], and every final best_dist <= the first step's, which
    is ``attack_batch`` at the initial weight tracked by loss_dist."""
    from geometric_adv_tpu_torch.attack.core import attack_batch, binary_search_attack
    from geometric_adv_tpu_torch.cli.common import AttackContext

    ctx = AttackContext(project, ae,
                        attack_pc_idx=f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy")
    src, tgt = (a[:pairs] for a in ctx.class_attack_data(CLASSES[0], ctx.point_clouds))
    tz = ctx.class_attack_data(CLASSES[0], ctx.latent_vectors)[1][:pairs]
    model = victim.model
    init, upper = 10.0, 100.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    first = attack_batch(model.encode, model.decode, t(src), t(tz), t(tgt),
                         torch.ones(pairs, device="cuda"), np.full((1, pairs), init, np.float32),
                         num_iterations=iters, num_iterations_thresh=1, track_by="loss_dist")
    t0 = time.time()
    counts, out = leg("binary search", counters, lambda: binary_search_attack(
        model.encode, model.decode, src, tz, tgt, device="cuda", init_dist_weight=init,
        upper_bound_dist_weight=upper, binary_search_step=steps, num_iterations=iters),
        required)
    seconds = time.time() - t0
    best_adv, best_dist, best_pc, weight = out
    first_dist = first.metrics[0, :, 1]
    print(f"binary_search_attack ({pairs} pairs, {steps} steps x {iters} iterations) in "
          f"{seconds:.2f} s: best_dist {best_dist.tolist()} (first step "
          f"{first_dist.tolist()}), weights {weight.tolist()}")
    if not all(np.isfinite(a).all() for a in out):
        fail("binary_search_attack returned non-finite values")
    if not ((weight >= 0) & (weight <= upper)).all():
        fail(f"binary_search_attack's weights left [0, {upper}]: {weight}")
    if not (best_dist <= first_dist).all():
        fail("binary_search_attack's best_dist is above its first step's")
    return counts


def check_trace(trace_dir, kernels):
    """The trace of ``run_attack --trace_dir`` exists and names ``kernels``
    (the port's own, by their function names)."""
    from geometric_adv_tpu_torch.utils.profiling import TRACE_FILE

    path = osp.join(trace_dir, TRACE_FILE)
    text = open(path).read()
    named = {k: f"::{k}" in text for k in kernels}
    print(f"trace {path}: {len(text)} bytes, the port's kernels named: {named}")
    if not all(named.values()):
        fail(f"the trace of run_attack --trace_dir misses a kernel: {named}")


def transfer_kernel_phase(cu, ch, metro, records):
    """The shapes the classifier, transfer and metro legs give the ported
    kernels. K2 at METRO_SHAPES on tie clouds (at 30000 points each block's
    rows no longer fit its shared memory and the x2 loop runs 15 chunks):
    bit-equal to its plain version in row chunks on the card (a minimum is
    exact in any order), a second run bit-equal, timed (CUDA events) beside
    its bound and the chunked plain version. K1 and K3 at TRANSFER_SHAPES
    on tie clouds: K1 bit-equal to its plain version with first-index
    argmins (past 2048 rows the straddling ties too), K3 bit-equal to the
    host's ascending-j sums and within GRAD_TOL of the card's plain version,
    second runs bit-equal; K1 timed by CUDA events, K3 by its device time.
    Each time goes into its record's ``shapes_ms``, with its bound and the
    plain version's time beside it."""
    def note(name, shape, ms, plain_ms, bound_ms):
        rec = records[name]
        rec.setdefault("shapes_ms", {})[shape] = ms
        rec.setdefault("shapes_plain_ms", {})[shape] = plain_ms
        rec.setdefault("shapes_bound_ms", {})[shape] = bound_ms
        print(f"  {name} at {shape}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}%), plain {plain_ms:.4f} ms")

    for b, n, m in METRO_SHAPES:
        x1, x2 = tie_clouds(b, n, m, seed=n + m)
        shape = f"[{b},{n},3]x[{b},{m},3]"
        got = cu.nn_distance_values_cuda(x1, x2)
        again = cu.nn_distance_values_cuda(x1, x2)
        want = metro.nn_distance_values_chunked(x1, x2, PLAIN_CHUNK)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"K2 differs from its chunked plain version at {shape}")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fail(f"K2's second run differs from its first at {shape}")
        print(f"kernel check K2 {shape}: bit-equal to its plain version in row chunks "
              f"of {PLAIN_CHUNK} on the card, second run bit-equal")
        note("nn_distance_values_cuda", shape,
             sync_timed(lambda: cu.nn_distance_values_cuda(x1, x2), 5),
             sync_timed(lambda: metro.nn_distance_values_chunked(x1, x2, PLAIN_CHUNK), 1),
             kernel_bound("nn_distance_values_cuda", b, n, m)[0])
        del x1, x2, got, again, want
        torch.cuda.empty_cache()

    for b, n, m in TRANSFER_SHAPES:
        x1, x2 = tie_clouds(b, n, m, seed=n)
        shape = f"[{b},{n},3]x[{b},{m},3]"
        k1 = cu.nn_distance_cuda(x1, x2)
        k1_again = cu.nn_distance_cuda(x1, x2)
        want = ch.nn_distance_plain(x1, x2)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(k1, want)):
            fail(f"K1 differs from its plain version at {shape}")
        if not all(torch.equal(g, a) for g, a in zip(k1, k1_again)):
            fail(f"K1's second run differs from its first at {shape}")
        if n >= N_POINTS:
            check_straddling_ties(k1, shape)
        rng = np.random.RandomState(n)
        g1, g2 = (torch.from_numpy(rng.rand(b, k).astype(np.float32)).cuda() for k in (n, m))
        args = (x1, x2, k1[1], k1[3], g1, g2)
        k3 = cu.chamfer_grad1_cuda(*args)
        k3_again = cu.chamfer_grad1_cuda(*args)
        plain = ch.chamfer_grad1_plain(*args)
        host = ch.chamfer_grad1_plain(*(t.cpu() for t in args))
        torch.cuda.synchronize()
        err = (k3 - plain).abs().max().item()
        if not (torch.equal(k3.cpu(), host) and torch.equal(k3, k3_again)):
            fail(f"K3 differs from the host's ascending-j sums or its first run at {shape}")
        if not err <= GRAD_TOL:
            fail(f"K3 differs from the card's plain version by {err} at {shape}")
        print(f"kernel check {shape}: K1 bit-equal to its plain version, first-index "
              f"argmins; K3 bit-equal to the host's ascending-j sums, {err:.3g} from the "
              f"card's plain version (tol {GRAD_TOL}); second runs bit-equal")
        note("nn_distance_cuda", shape, sync_timed(lambda: cu.nn_distance_cuda(x1, x2), 20),
             sync_timed(lambda: ch.nn_distance_plain(x1, x2), 3),
             kernel_bound("nn_distance_cuda", b, n, m)[0])
        note("chamfer_grad1_cuda", shape, device_timed(lambda: cu.chamfer_grad1_cuda(*args), 50),
             sync_timed(lambda: ch.chamfer_grad1_plain(*args), 5),
             kernel_bound("chamfer_grad1_cuda", b, n, m)[0])
        del x1, x2, k1, k1_again, want, args, k3, k3_again, plain, host
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def classifier_stages(project, ae):
    """The classifier CLIs on the card, in order: train (2 epochs of batch
    32 on the 2048-point train split), test, and each data_type classified
    and evaluated both ways on the chamfer victim's attack and its critical
    defense."""
    from geometric_adv_tpu_torch.cli import (
        evaluate_classifier,
        run_classifier,
        train_classifier,
        tst_classifier,
    )

    c = ["--project_dir", project, "--ae_folder", ae, "--device", "cuda"]
    a = c + ["--attack_pc_idx", f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy"]
    stages = [
        ("train_classifier", train_classifier.main,
         c + ["--data_folder", "data/synthetic", "--max_epoch", "2", "--batch_size", "32"]),
        ("tst_classifier", tst_classifier.main, c),
    ]
    stages += [(f"run_classifier {dt}", run_classifier.main, a + ["--data_type", dt])
               for dt in CLS_DATA_TYPES]
    stages += [(f"evaluate_classifier {dt} {ct}", evaluate_classifier.main,
                a + ["--data_type", dt, "--classification_type", ct])
               for dt in CLS_DATA_TYPES for ct in ("hit_target", "avoid_source")]
    return stages


def check_classifier(project, ae, stages, n_test):
    """The classifier's artifacts (labels int8 of the JAX stages' shapes,
    the ten eval_stats files), its train samples/s and inference clouds/s at
    batch 250, and its test-set labels recomputed on the host from the
    saved checkpoint: equal to the card's except where the host's margin
    between its top logit and the card's label's is within CLS_NEAR_TIE of
    the cloud's largest |logit| (cuBLAS and the host's BLAS round the
    1024-wide products differently), each flip printed. Returns (train
    samples/s, clouds/s, flips)."""
    from geometric_adv_tpu_torch.classify import ClassifierTrainer

    ev = osp.join(project, ae, "eval")
    card = np.load(osp.join(ev, "pc_pred_labels_test_set_13l.npy"))
    if card.shape != (n_test,) or card.dtype != np.int8:
        fail(f"pc_pred_labels_test_set: {card.shape} {card.dtype}")
    res = osp.join(ev, "attack_res")
    pairs = 4 * (len(CLASSES) - 1) * 2
    files = {"target": "classifier_res_orig/{c}/target_pc_recon_pred.npy",
             "adversarial": "classifier_res/{c}/adversarial_pc_recon_pred.npy",
             "source": "defense_critical_res/classifier_res_orig/{c}/source_pc_recon_pred.npy",
             "after_defense":
                 "defense_critical_res/classifier_res/{c}/defended_pc_recon_pred.npy"}
    for dt, rel in files.items():
        for c in CLASSES:
            pred = np.load(osp.join(res, rel.format(c=c)))
            if pred.shape != (1, pairs) or pred.dtype != np.int8:
                fail(f"{rel.format(c=c)}: {pred.shape} {pred.dtype}")
    for dt in CLS_DATA_TYPES:
        folder = {"target": "classifier_res_orig", "adversarial": "classifier_res",
                  "source": "defense_critical_res/classifier_res_orig"}.get(
                      dt, "defense_critical_res/classifier_res")
        for ct in ("hit_target", "avoid_source"):
            text = open(osp.join(res, folder, "over_classes",
                                 f"eval_stats_{dt}_{ct}.txt")).read()
            if "over classes" not in text:
                fail(f"eval_stats_{dt}_{ct}.txt is incomplete")

    stats = stages["train_classifier"][1]
    per_epoch = (4 * 51 // 32) * 32
    rate = (len(stats) - 1) * per_epoch / sum(s[3] for s in stats[1:])
    print(f"classifier training: loss by epoch {[round(s[1], 4) for s in stats]}, "
          f"accuracy {[round(s[2], 4) for s in stats]}; {rate:.1f} samples/s over epochs "
          f"2-{len(stats)} ({per_epoch} per epoch); first epoch {stats[0][3]:.3f} s")
    if not np.isfinite([s[1] for s in stats]).all():
        fail("the classifier's training loss is not finite")

    from geometric_adv_tpu_torch.utils.artifacts import load_data

    pcs = load_data(ev, None, ["point_clouds_test_set"])
    trainer = ClassifierTrainer(num_classes=len(CLASSES), device="cuda").restore(osp.join(project, "log/pointnet"))
    batch = np.tile(pcs, (-(-250 // len(pcs)), 1, 1))[:250]
    trainer.classify(batch)  # warm-up
    t0 = time.time()
    for _ in range(3):
        trainer.classify(batch)
    clouds_s = 3 * 250 / (time.time() - t0)
    print(f"classifier inference at batch 250: {clouds_s:.1f} clouds/s")

    host = ClassifierTrainer(num_classes=len(CLASSES), device="cpu").restore(osp.join(project, "log/pointnet"))
    logits = host._logits(torch.from_numpy(pcs)).numpy()
    flips = []
    for p in np.flatnonzero(logits.argmax(-1) != card):
        top = logits[p].max()
        margin = float(top - logits[p, card[p]])
        flips.append(margin / np.abs(logits[p]).max())
        print(f"  label flip, test cloud {p}: host {logits[p].argmax()}, card {card[p]}, "
              f"host margin {margin:.3g} of max |logit| {np.abs(logits[p]).max():.6g}")
        if not flips[-1] <= CLS_NEAR_TIE:
            fail(f"the card's label of test cloud {p} is not a near-tie on the host")
    print(f"classifier labels on the host: {len(pcs) - len(flips)} of {len(pcs)} equal to "
          f"the card's, {len(flips)} near-ties (bar {CLS_NEAR_TIE}); card test accuracy "
          f"{stages['tst_classifier'][1][0]:.4f}")
    return rate, clouds_s, flips


def transfer_stages(project, ae):
    """The transfer CLIs on the card: AtlasNet (2500 points, one SPHERE
    primitive, bottleneck 1024) and FoldingNet (2025 points) trained 2
    epochs of batch 16, tested, run on the chamfer victim's attack and
    evaluated; then the victim as its own transfer AE with the identity
    replay checks."""
    from geometric_adv_tpu_torch.cli import (
        evaluate_transfer,
        run_transfer,
        train_transfer,
        tst_transfer,
    )

    c = ["--project_dir", project, "--ae_folder", ae, "--device", "cuda"]
    a = c + ["--attack_pc_idx", f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy"]
    stages = []
    for kind, name, extra in (
            ("atlasnet", "AtlasNet", ["--number_points", str(TRANSFER_POINTS["atlasnet"])]),
            ("foldingnet", "FoldingNet", [])):
        folder = f"log/{kind}_for_transfer"
        stages += [
            (f"train_transfer {kind}", train_transfer.main,
             c + ["--ae_type", kind, "--data_folder", "data/synthetic", "--epochs", "2",
                  "--batch_size", "16"] + extra),
            (f"tst_transfer {kind}", tst_transfer.main,
             c + ["--ae_type", kind, "--train_folder", folder]),
            (f"run_transfer {name}", run_transfer.main,
             a + ["--transfer_ae_type", name, "--transfer_ae_folder", folder]),
            (f"evaluate_transfer {name}", evaluate_transfer.main,
             a + ["--transfer_ae_type", name]),
        ]
    stages.append(("run_transfer PointNet, identity replay", run_transfer.main,
                   a + ["--transfer_ae_type", "PointNet", "--transfer_ae_folder", ae,
                        "--do_sanity_checks", "1"]))
    return stages


def check_transfer(project, ae, stages, n_test):
    """Per transfer AE: K1 and K3 launched in its training, its artifacts
    of the JAX stages' shapes, finite, and the first class's T-RE recomputed
    on the host from the saved checkpoint within rtol 2e-4 of the card's
    (their BLAS round differently); its train samples/s over the second
    epoch. Returns {kind: samples/s}."""
    from geometric_adv_tpu_torch.attack.pipeline import get_quantity_at_index
    from geometric_adv_tpu_torch.cli.common import AttackContext
    from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
    from geometric_adv_tpu_torch.transfer import get_transfer_ae, load_transfer_arch

    res = osp.join(project, ae, "eval", "attack_res")
    pairs = 4 * (len(CLASSES) - 1) * 2
    ctx = AttackContext(project, ae, attack_folder="attack_res",
                        attack_pc_idx=f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy")
    c = CLASSES[0]
    _, target = ctx.class_attack_data(c, ctx.point_clouds)
    adv = get_quantity_at_index(
        [np.load(osp.join(res, c, "adversarial_pc_input.npy"))],
        np.load(osp.join(res, c, "analysis_results", "source_target_norm_min_idx.npy")))
    rates = {}
    for kind, n_out in TRANSFER_POINTS.items():
        made = stages[f"train_transfer {kind}"][2]
        if made["nn_distance_cuda"] <= 0 or made["chamfer_grad1_cuda"] <= 0:
            fail(f"train_transfer {kind} launched {made}, not K1 and K3")
        folder = osp.join(project, f"log/{kind}_for_transfer")
        want = {f"eval/reconstructions_test_set_13l.npy": (n_test, n_out, 3),
                f"eval/ae_loss_test_set_13l.npy": (n_test,)}
        for rel, shape in want.items():
            a = np.load(osp.join(folder, rel))
            if a.shape != shape or not np.isfinite(a).all():
                fail(f"{kind} {rel}: {a.shape}, finite {np.isfinite(a).all()}")
        for cls in CLASSES:
            m = np.load(osp.join(res, f"transfer_res_{kind}", cls, "transfer_metrics.npy"))
            r = np.load(osp.join(res, f"transfer_res_{kind}", cls, "transferred_pc_recon.npy"))
            if m.shape != (1, pairs, 4) or r.shape != (1, pairs, n_out, 3):
                fail(f"{kind} transfer artifacts of {cls}: {m.shape} {r.shape}")
            if not (np.isfinite(m).all() and np.isfinite(r).all()):
                fail(f"{kind} transfer artifacts of {cls} are not finite")
        if "over classes" not in open(osp.join(res, f"transfer_res_{kind}", "over_classes",
                                               "eval_stats.txt")).read():
            fail(f"{kind} eval_stats.txt is incomplete")
        arch = load_transfer_arch(folder)
        arch.pop("ae_type")
        host = get_transfer_ae(kind, device="cpu", **arch).restore(folder)
        recon = host.get_reconstructions(adv, batch_size=4)
        with torch.no_grad():
            tre = np.concatenate([chamfer_loss_per_pc(
                torch.from_numpy(recon[i:i + 1]), torch.from_numpy(target[i:i + 1])).numpy()
                for i in range(len(adv))])
        card = np.load(osp.join(res, f"transfer_res_{kind}", c, "transfer_metrics.npy"))[0, :, 0]
        rel = float(np.max(np.abs(tre - card) / np.abs(card)))
        stats = stages[f"train_transfer {kind}"][1]
        per_epoch = (4 * 51 // 16) * 16
        rates[kind] = (len(stats) - 1) * per_epoch / sum(s[2] for s in stats[1:])
        print(f"transfer {kind}: loss by epoch {[round(s[1], 6) for s in stats]}, "
              f"{rates[kind]:.1f} train samples/s over epoch 2 ({per_epoch} per epoch; "
              f"first epoch {stats[0][2]:.3f} s); training launched {made}; {c}'s T-RE on "
              f"the host within {rel:.3g} relative of the card's (rtol 2e-4)")
        if not rel <= 2e-4:
            fail(f"{kind}'s T-RE on the host differs from the card's by {rel} relative")
    return rates


def foldingnet_step_profile():
    """One FoldingNet train step at the trainer's [16, 2048] on surface
    clouds: its device time, that of ``knn_point`` (k = 17) and of the whole
    graph preparation at the same shape, and the step's top kernels.
    Returns knn_point's share of the step's device time."""
    from geometric_adv_tpu_torch.models.foldingnet import NUM_KNN, graph_features
    from geometric_adv_tpu_torch.ops.grouping import knn_point
    from geometric_adv_tpu_torch.transfer import FoldingNetTrainer

    trainer = FoldingNetTrainer(device="cuda")
    x = surface_clouds(16, N_POINTS, seed=9)[0]
    step_ms = device_timed(lambda: trainer._train_step(x), 3)
    knn_ms = device_timed(lambda: knn_point(NUM_KNN + 1, x, x), 3)
    graph_ms = device_timed(lambda: graph_features(x), 3)
    share = knn_ms / step_ms
    print(f"FoldingNet train step at [16, {N_POINTS}]: {step_ms:.3f} ms on the device; "
          f"knn_point (k = {NUM_KNN + 1}) {knn_ms:.3f} ms ({100 * share:.1f}% of the step), "
          f"graph_features {graph_ms:.3f} ms")
    device_breakdown(lambda: trainer._train_step(x), f"one FoldingNet train step at [16, {N_POINTS}]")
    return share


def metro_stages(project, ae):
    """AtlasNet with the SQUARE template (2500 points, a 50 x 50 grid)
    trained 2 epochs, then run_metro over CLASSES (all meshable), 2
    instances each, at METRO_SAMPLES samples a side."""
    from geometric_adv_tpu_torch.cli import run_metro, train_transfer

    c = ["--project_dir", project, "--ae_folder", ae, "--device", "cuda"]
    return [
        ("train_transfer atlasnet SQUARE", train_transfer.main,
         c + ["--ae_type", "atlasnet", "--data_folder", "data/synthetic", "--epochs", "2",
              "--batch_size", "16", "--number_points", "2500", "--template_type", "SQUARE",
              "--train_folder", METRO_FOLDER]),
        ("run_metro", run_metro.main,
         c + ["--transfer_ae_folder", METRO_FOLDER, "--class_names", *CLASSES,
              "--num_per_class", str(METRO_PER_CLASS), "--n_samples", str(METRO_SAMPLES)]),
    ]


def check_metro(project, stages, metro):
    """run_metro launched K2 exactly once per mesh pair and nothing else;
    each pair, rebuilt as run_metro builds it (the same instances, mesh and
    seeded samples on the card), gives the saved distance through K2, and
    the host's chunked plain route on the same samples gives it too.
    Returns seconds per mesh pair."""
    from geometric_adv_tpu_torch.data.synthetic import sample_shape_and_mesh
    from geometric_adv_tpu_torch.transfer import get_transfer_ae, load_transfer_arch

    seconds, rows, made = stages["run_metro"]
    n_pairs = len(CLASSES) * METRO_PER_CLASS
    if made != {"nn_distance_values_cuda": n_pairs, "nn_distance_cuda": 0,
                "chamfer_grad1_cuda": 0}:
        fail(f"run_metro launched {made}, not K2 once for each of {n_pairs} mesh pairs")
    folder = osp.join(project, METRO_FOLDER)
    saved = np.load(osp.join(folder, "eval", "metro_distances.npy"))
    arch = load_transfer_arch(folder)
    arch.pop("ae_type")
    trainer = get_transfer_ae("atlasnet", device="cuda", **arch).restore(folder)
    rng = np.random.RandomState(17)  # run_metro's --seed
    k, host_s = 0, 0.0
    for name in CLASSES:
        draws = [sample_shape_and_mesh(name, N_POINTS, rng) for _ in range(METRO_PER_CLASS)]
        for i, (pc, (gv, gf)) in enumerate(draws):
            mv, mf = metro.atlasnet_generate_mesh(trainer, pc)
            gen = torch.Generator(device="cuda").manual_seed(17 + i)
            s1 = metro.sample_mesh_surface(mv, mf, METRO_SAMPLES, gen, "cuda")
            s2 = metro.sample_mesh_surface(gv, gf, METRO_SAMPLES, gen, "cuda")
            card = float(metro.hausdorff_sampled(s1, s2))
            t0 = time.time()
            host = float(metro.hausdorff_sampled(s1.cpu(), s2.cpu()))
            host_s += time.time() - t0
            print(f"  metro {name} #{i}: {card:.6f} through K2, {host:.6f} on the host, "
                  f"{float(saved[k]):.6f} saved by run_metro ({len(mv)} vertices, "
                  f"{len(mf)} faces against {len(gf)})")
            if not (card == host and np.float32(card) == saved[k]):
                fail(f"metro pair {k} ({name}): K2 {card}, host {host}, saved {saved[k]}")
            k += 1
    print(f"metro: {n_pairs} pairs, K2 once each; every distance equal to the host's "
          f"chunked plain route on the same samples ({host_s:.1f} s on the host) and to "
          f"run_metro's; {seconds / n_pairs:.3f} s per mesh pair (stage {seconds:.2f} s)")
    return seconds / n_pairs


# --- the native loader, the sparse VJP, precision, the importers, verify_cuda --

SPARSE_ITERS = (100, 80)  # the sparse/dense attack pair's iterations
SPARSE_RTOL, SPARSE_ATOL = 2e-4, 1e-6  # tests/test_sparse_encode.py:161-164
RECON_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_model_ae.py:18


# --- the eval forward's batch invariance, and the mesh leg -------------------
MESH_RANKS = 2  # the mesh leg's ranks, both on the one card
MESH_ITERS = (100, 80)
MESH_BATCH = 48  # a class's pair grid (4 sources x 3 classes x 4 targets) in one
#                  call of the 2-rank attack: 24 pairs a rank
MESH_TIMEOUT = 300  # seconds a process of the mesh leg may take
ATTACK_BAR = dict(rtol=1e-5, atol=1e-6)  # tests/test_distributed.py:120-121
MATRIX_BAR = dict(rtol=1e-5, atol=1e-7)  # tests/test_distributed.py:271-272
FORWARD_BAR = dict(rtol=1e-5, atol=1e-6)  # tests/test_distributed.py:285-288


def dataset_clouds(project, data="data/synthetic"):
    """The synthetic dataset's 240 clouds, class by class."""
    from geometric_adv_tpu_torch.data.datasets import load_point_clouds_under_folder

    return np.concatenate([load_point_clouds_under_folder(osp.join(project, data, c))
                           for c in CLASSES]).astype(np.float32)


def check_batch_invariance(victim, clouds, label):
    """A cloud's eval-forward results must not depend on the batch it sits
    in: ``get_reconstructions`` and ``get_loss_per_pc`` on 12 clouds at
    once against rows of 4, and three clouds at offsets 0 and 5 in batches
    of 1-40 against the same clouds alone, all at 0. The victim's plain
    forward (one call, no blocks) is swept the same way and printed beside
    it, with the time of each over ``clouds``."""
    x = clouds[:12]

    def in_fours(fn):
        return np.concatenate([fn(x[i:i + 4]) for i in range(0, 12, 4)])

    drift = {
        "get_reconstructions": float(np.abs(
            victim.get_reconstructions(x) - in_fours(victim.get_reconstructions)).max()),
        "get_loss_per_pc": float(np.abs(
            victim.get_loss_per_pc(x) - in_fours(victim.get_loss_per_pc)).max()),
    }

    def plain(a):
        with torch.no_grad():
            return victim.model(torch.as_tensor(a, device="cuda"))[0]

    probe = clouds[:3]
    alone = (victim.get_reconstructions(probe), victim.get_loss_per_pc(probe), plain(probe))
    sweep = plain_sweep = 0.0
    for b in range(1, 41):
        for off in (0, 5):
            batch = np.concatenate([clouds[20:20 + off], probe, clouds[40:40 + b]])
            rows = slice(off, off + 3)
            sweep = max(sweep,
                        float(np.abs(victim.get_reconstructions(batch)[rows] - alone[0]).max()),
                        float(np.abs(victim.get_loss_per_pc(batch)[rows] - alone[1]).max()))
            plain_sweep = max(plain_sweep,
                              (plain(batch)[rows] - alone[2]).abs().max().item())
    blocked_ms = sync_timed(lambda: victim.get_reconstructions(clouds), 5)
    plain_ms = sync_timed(lambda: plain(clouds).cpu(), 5)
    print(f"eval forward batch invariance ({label}): 12 clouds at once vs rows of 4 "
          f"{drift}; three clouds in batches of 1-40 at offsets 0/5 vs alone {sweep:.3e}; "
          f"the plain forward (one call, no blocks) {plain_sweep:.3e}; get_reconstructions "
          f"of {len(clouds)} clouds {blocked_ms:.2f} ms, the plain forward {plain_ms:.2f} ms")
    if max(drift.values()) or sweep:
        fail(f"the {label} victim's eval forward depends on the batch: {drift}, {sweep}")
    return drift, sweep, plain_sweep


def mesh_rank(argv) -> int:
    """One process of the mesh leg (``chip_smoke.py --mesh-rank OUT
    run_attack flags...``), started by ``mesh_leg`` with the GAT_ variables
    or none: runs run_attack, and where the flags say so the chamfer matrix
    and the batched forward under the mesh, then the mesh training leg's
    ``train_ae`` runs (``mesh_train_stages``), each between barriers with
    the launch counts zeroed, and writes what it measured to
    OUT/rank<r>.json."""
    from geometric_adv_tpu_torch.cli import common, run_attack
    from geometric_adv_tpu_torch.ops import bn_relu as bn_op
    from geometric_adv_tpu_torch.ops.cuda import bn_relu as cu_bn
    from geometric_adv_tpu_torch.ops.cuda import build
    from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix
    from geometric_adv_tpu_torch.parallel import barrier, get_mesh
    from geometric_adv_tpu_torch.train.config import Configuration

    out, stages, flags = argv[0], argv[1], argv[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    mesh = get_mesh()
    dist = torch.distributed
    report = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
              "current_device": torch.cuda.current_device(),
              "backend": dist.get_backend() if dist.is_initialized() else None}

    def timed(name, fn):
        cu.reset_launch_counts()
        barrier()
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        report[name + "_s"] = time.time() - t0
        report[name + "_launches"] = cu.launch_counts()
        barrier()
        return result

    timed("attack", lambda: run_attack.main(flags))
    if stages == "all":
        project, ae = flags[flags.index("--project_dir") + 1], flags[flags.index("--ae_folder") + 1]
        clouds = np.load(osp.join(out, "clouds.npy"))
        mat = timed("matrix", lambda: chamfer_distance_matrix(clouds, "cuda", mesh=mesh))
        victim = common.restore_victim(
            Configuration.load(osp.join(project, ae, "configuration")),
            osp.join(project, ae), "cuda", mesh=mesh)
        recon = timed("forward", lambda: victim.get_reconstructions(clouds))
        amax, vmax = victim.get_pre_symmetry_argmax(clouds)
        np.savez(osp.join(out, f"rank{mesh.rank}.npz"), matrix=mat, recon=recon,
                 amax=amax, vmax=vmax)
    mesh_train_stages(flags[flags.index("--project_dir") + 1], mesh, report)
    with open(osp.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def start_ranks(out, ranks, stages, flags):
    """``ranks`` processes of ``mesh_rank`` (the GAT_ variables where more
    than one); -> their reports and the wall clock of the whole run. A rank
    that exits non-zero or outlasts MESH_TIMEOUT fails the run."""
    import socket

    os.makedirs(out, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.time()
    for rank in range(ranks):
        env = dict(os.environ)
        if ranks > 1:
            env.update(GAT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       GAT_NUM_PROCESSES=str(ranks), GAT_PROCESS_ID=str(rank))
        log = open(osp.join(out, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, osp.abspath(__file__), "--mesh-rank", out, stages, *flags],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for rank, (proc, log) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, t0 + MESH_TIMEOUT - time.time()))
            except subprocess.TimeoutExpired:
                fail(f"mesh rank {rank} of {ranks} outlasted {MESH_TIMEOUT} s")
            if rc:
                tail = open(osp.join(out, f"rank{rank}.log")).read()[-3000:]
                fail(f"mesh rank {rank} of {ranks} exited {rc}:\n{tail}")
    finally:
        for proc, log in procs:
            proc.kill()
            proc.wait()
            log.close()
    wall = time.time() - t0
    return [json.load(open(osp.join(out, f"rank{r}.json"))) for r in range(ranks)], wall


def mesh_leg(project, ae, victim, smi):
    """Two ranks on the one card, started with the GAT_ variables: the
    composed chamfer attack (100/80 iterations, 48 pairs a call, so 24 a
    rank) against one process at calls of 24, the chamfer matrix over the
    dataset's 240 clouds and ``get_reconstructions`` /
    ``get_pre_symmetry_argmax`` over them under the mesh against one
    process; K1 and K3 must launch on both ranks in the attack, K2 in the
    matrix. Returns the leg's launches, its numbers and the reports of the
    one-rank run and of the two ranks, which hold the mesh training leg's
    results too."""
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix

    out = osp.join(project, "mesh")
    os.makedirs(out, exist_ok=True)
    clouds = dataset_clouds(project)
    np.save(osp.join(out, "clouds.npy"), clouds)

    def flags(batch, folder):
        return ["--project_dir", project, "--device", "cuda", "--ae_folder", ae,
                "--attack_pc_idx", f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy",
                "--num_pc_for_attack", "4", "--num_pc_for_target", "4",
                "--num_iterations", str(MESH_ITERS[0]),
                "--num_iterations_thresh", str(MESH_ITERS[1]),
                "--chamfer_impl", "composed", "--batch_size", str(batch),
                "--output_folder_name", folder]

    one, one_wall = start_ranks(osp.join(out, "one"), 1, "attack",
                                flags(MESH_BATCH // MESH_RANKS, "attack_res_mesh1"))
    two, two_wall = start_ranks(out, MESH_RANKS, "all", flags(MESH_BATCH, "attack_res_mesh2"))
    for r in two:
        print(f"mesh rank {r['rank']} of {r['size']}: device {r['device']} (current "
              f"{r['current_device']}), backend {r['backend']}; attack launches "
              f"{r['attack_launches']}, matrix launches {r['matrix_launches']}")
        if (r["size"], r["backend"]) != (MESH_RANKS, "gloo"):
            fail(f"mesh rank {r['rank']}: size {r['size']}, backend {r['backend']}")
        for stage, kernels in (("attack", ("nn_distance_cuda", "chamfer_grad1_cuda")),
                               ("matrix", ("nn_distance_values_cuda",))):
            for k in kernels:
                if r[stage + "_launches"][k] <= 0:
                    fail(f"{k} was not launched on mesh rank {r['rank']} in the {stage}")
    ev = osp.join(project, ae, "eval")
    attack_diff = 0.0
    for c in CLASSES:
        for name in ("adversarial_metrics", "adversarial_pc_input", "adversarial_pc_recon"):
            want = np.load(osp.join(ev, "attack_res_mesh1", c, name + ".npy"))
            got = np.load(osp.join(ev, "attack_res_mesh2", c, name + ".npy"))
            if got.shape != want.shape or got.shape[1] != MESH_BATCH:
                fail(f"the mesh attack's {c}/{name}: {got.shape} vs {want.shape}")
            np.testing.assert_allclose(got, want, **ATTACK_BAR, err_msg=f"{c}/{name}")
            attack_diff = max(attack_diff, float(np.abs(got - want).max()))
    impl = json.load(open(osp.join(ev, "attack_res_mesh2", "attack_impl.json")))
    if impl["processes"] != MESH_RANKS or impl["batch_size"] != MESH_BATCH:
        fail(f"the mesh attack recorded {impl}")
    single = chamfer_distance_matrix(clouds, "cuda")
    recon = victim.get_reconstructions(clouds)
    amax, vmax = victim.get_pre_symmetry_argmax(clouds)
    ranks = [dict(np.load(osp.join(out, f"rank{r}.npz"))) for r in range(MESH_RANKS)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if not np.array_equal(r[k], v):
                fail(f"the mesh ranks disagree on {k}")
    got = ranks[0]
    np.testing.assert_allclose(got["matrix"], single, **MATRIX_BAR)
    np.testing.assert_allclose(got["recon"], recon, **FORWARD_BAR)
    np.testing.assert_allclose(got["vmax"], vmax, **FORWARD_BAR)
    np.testing.assert_array_equal(got["amax"], amax)
    diffs = {"attack": attack_diff,
             "matrix": float(np.abs(got["matrix"] - single).max()),
             "reconstructions": float(np.abs(got["recon"] - recon).max()),
             "argmax mismatches": int((got["amax"] != amax).sum())}
    one_s = one[0]["attack_s"]
    two_s = max(r["attack_s"] for r in two)
    pair_iters = len(CLASSES) * MESH_BATCH * MESH_ITERS[0]
    print(f"mesh leg ({smi}): largest differences against one process {diffs}; "
          f"run_attack of {pair_iters // MESH_ITERS[0]} pairs x {MESH_ITERS[0]} iterations: "
          f"2 ranks on one card {two_s:.2f} s ({pair_iters / two_s:.1f} pair-iters/s), "
          f"1 rank {one_s:.2f} s ({pair_iters / one_s:.1f} pair-iters/s), "
          f"{one_s / two_s:.3f}x; whole runs with start-up (the mesh training leg's "
          f"runs included) {two_wall:.2f} s and {one_wall:.2f} s; matrix under the mesh {two[0]['matrix_s']:.3f} s")
    launches = {}
    for r in one + two:
        for stage in ("attack", "matrix", "forward"):
            for k, v in r.get(stage + "_launches", {}).items():
                launches[k] = launches.get(k, 0) + v
    return launches, {"mesh attack s, 2 ranks / 1 rank": [two_s, one_s],
                      "mesh largest differences": diffs}, (one[0], two)


# --- training under the mesh ----------------------------------------------------
# (loss, points, dataset, epochs, learning rate or None for train_ae's
# default 5e-4): full width, batch 50. The chamfer run trains at a tenth of
# the default: there, one ulp of input moves one process's per-epoch losses
# by less than TRAIN_BAR, while at the default Adam's sign-normalised first
# steps carry the chamfer NN's flips on near-ties to ~1e-4 (``ulp_control``
# measures both in every run), beyond any bar two reduction orders can meet
MESH_TRAINING = (
    ("chamfer", N_POINTS, "data/synthetic", 2, 5e-5),
    ("emd", 1024, "data/synthetic_1024", 1, None),
)
DEFAULT_LR = 5e-4  # train_ae's (train/config.py::default_train_params)
MESH_TRAIN_KERNELS = {"chamfer": ("nn_distance_cuda", "chamfer_grad1_cuda"),
                      "emd": ("emd_sweep_block_cuda",)}
TRAIN_BAR = dict(rtol=1e-5)  # tests/test_distributed.py:186
CKPT_BAR = dict(atol=5e-3)  # tests/test_distributed.py:215-223 (loss: rtol 5e-3)


def state_checksums(trainer) -> dict:
    """sha1 of every tensor of the trainer: parameters, BN running
    statistics, Adam moments and step."""
    import hashlib

    tensors = dict(trainer.model.state_dict())
    for name, p in trainer.model.named_parameters():
        for k, v in trainer.optimizer.state[p].items():
            tensors[f"adam.{name}.{k}"] = v
    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def mesh_train_folder(loss, n_points, ranks):
    return f"log/mesh_train_{loss}_{n_points}_{ranks}proc"


def ulp_control(project, data, n_points, epochs, lr, want):
    """One process's own sensitivity: the leg's chamfer training run in
    process on train_ae's training set (sort_axes, the seed-55 shuffle) as
    is and one ulp up, at the leg's rate and at train_ae's default; the run
    as is at the leg's rate must give ``want``, train_ae's losses, bit for
    bit. -> {rate: the largest relative per-epoch difference one ulp made}."""
    from geometric_adv_tpu_torch.data.augment import sort_axes
    from geometric_adv_tpu_torch.data.datasets import PointCloudDataSet, load_dataset
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    train = PointCloudDataSet(sort_axes(load_dataset(CLASSES, "train_set",
                                                     osp.join(project, data))[0]),
                              init_shuffle=False)
    train.shuffle_data(seed=55)
    clouds = train.point_clouds.astype(np.float32)
    moved = {}
    for rate in (lr, DEFAULT_LR):
        conf = Configuration(n_input=[n_points, 3], loss="chamfer", batch_size=50,
                             learning_rate=rate, training_epochs=epochs,
                             saver_step=None, held_out_step=None)
        losses = [np.array([s[1] for s in AETrainer(conf, "cuda").train(
            PointCloudDataSet(x, init_shuffle=False), conf)])
            for x in (clouds, np.nextafter(clouds, np.float32(np.inf)))]
        if rate == lr and losses[0].tolist() != want:
            fail(f"the in-process chamfer run gave {losses[0]}, train_ae {want}")
        moved[rate] = float((np.abs(losses[1] - losses[0]) / losses[0]).max())
    return moved


def nccl_phase(report):
    """One process forms a one-rank NCCL group on the card and passes CUDA
    tensors through ``all_reduce_sum`` and the differentiable all-reduce,
    forward and backward: each must return its input."""
    import socket

    from geometric_adv_tpu_torch import parallel

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    parallel.form_group(f"127.0.0.1:{port}", 1, 0)
    mesh = parallel.get_mesh()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4096, generator=gen, device="cuda")
    dy = torch.randn(4096, generator=gen, device="cuda")
    summed = parallel.all_reduce_sum(x.clone(), mesh)
    xg = x.clone().requires_grad_(True)
    y = parallel.differentiable_all_reduce_sum(xg, mesh)
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    report["nccl"] = {"backend": parallel.device_backend(),
                      "all_reduce_sum": bool(torch.equal(summed, x)),
                      "forward": bool(torch.equal(y.detach(), x)),
                      "backward": bool(torch.equal(xg.grad, dy))}


def mesh_train_stages(project, mesh, report):
    """The mesh training leg's part of a rank: ``train_ae`` for each of
    MESH_TRAINING, each between barriers with the launch counts zeroed,
    then every tensor's checksum; alone, ``ulp_control`` and the NCCL
    phase after. Adds them to ``report``."""
    from geometric_adv_tpu_torch import parallel
    from geometric_adv_tpu_torch.cli import train_ae
    from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
    from geometric_adv_tpu_torch.ops.cuda import emd as cu_emd

    report["device_backend"] = parallel.device_backend()
    trainers = []

    class Recorded(train_ae.AETrainer):  # keeps the stage's trainer to read
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    train_ae.AETrainer = Recorded
    for loss, n_points, data, epochs, lr in MESH_TRAINING:
        for mod in (cu, cu_emd):
            mod.reset_launch_counts()
        parallel.barrier()
        t0 = time.time()
        stats = train_ae.main([
            "--project_dir", project, "--device", "cuda", "--data_folder", data,
            "--n_points", str(n_points), "--loss", loss, "--batch_size", "50",
            "--training_epochs", str(epochs), "--learning_rate", str(lr or DEFAULT_LR),
            "--train_folder", mesh_train_folder(loss, n_points, mesh.size)])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = {**cu.launch_counts(), **cu_emd.launch_counts()}
        parallel.barrier()
        report[loss] = {"losses": [s[1] for s in stats], "epoch_s": [s[2] for s in stats],
                        "s": seconds, "launches": launches,
                        "checksums": state_checksums(trainers[-1])}
    if mesh.size == 1:
        loss, n_points, data, epochs, lr = MESH_TRAINING[0]
        report["ulp_control"] = ulp_control(project, data, n_points, epochs, lr,
                                            report[loss]["losses"])
        nccl_phase(report)


def mesh_train_leg(project, smi, one, two):
    """``train_ae`` under the mesh (run by ``mesh_leg``'s processes after
    their stages, ``one`` and ``two`` their reports): two ranks on the one
    card against one process, chamfer at 2048 points for 2 epochs and EMD
    at 1024 for 1, at full width and batch 50. Each rank must report gloo (the ranks share
    cuda:0), the per-epoch losses must match one process at rtol 1e-5, every
    rank's tensors rank 0's bit for bit, the restored checkpoints each
    other on 8 test clouds (reconstructions atol 5e-3, loss rtol 5e-3), and
    each rank must launch the one process's kernels, K1 and K3 (chamfer)
    and K6 (EMD) among them; train_stats.txt is written once. Then the
    NCCL phase's result. Returns the leg's launches and its numbers."""
    from geometric_adv_tpu_torch.data.augment import sort_axes
    from geometric_adv_tpu_torch.data.datasets import load_dataset
    from geometric_adv_tpu_torch.train import checkpoint as ckpt
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import build_trainer_from_checkpoint

    for r in two:
        backend = r["device_backend"]
        print(f"mesh training rank {r['rank']} of {r['size']}: device {r['device']}, "
              f"device backend {backend}")
        if backend is None or backend[0] != "gloo" or "share cuda:0" not in backend[1]:
            fail(f"mesh training rank {r['rank']}: device backend {backend}, not gloo "
                 "for two ranks on cuda:0")
    numbers, launches = {}, {}
    for loss, n_points, data, epochs, lr in MESH_TRAINING:
        want = one[loss]
        ran = {k for k, v in want["launches"].items() if v > 0}
        if not set(MESH_TRAIN_KERNELS[loss]) <= ran:
            fail(f"one-process {loss} training launched {sorted(ran)}")
        for r in two:
            got = r[loss]
            np.testing.assert_allclose(got["losses"], want["losses"], **TRAIN_BAR,
                                       err_msg=f"{loss} rank {r['rank']}")
            if got["checksums"] != two[0][loss]["checksums"]:
                bad = [k for k, v in got["checksums"].items()
                       if v != two[0][loss]["checksums"][k]]
                fail(f"{loss}: rank {r['rank']}'s tensors differ from rank 0's: {bad}")
            if {k for k, v in got["launches"].items() if v > 0} != ran:
                fail(f"{loss}: rank {r['rank']} launched {got['launches']}, one process "
                     f"{want['launches']}")
        for r in (one, *two):
            for k, v in r[loss]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        folders = [osp.join(project, mesh_train_folder(loss, n_points, n)) for n in (1, 2)]
        rows = open(osp.join(folders[1], "train_stats.txt")).read().splitlines()
        if [ln.split("\t")[0] for ln in rows] != [f"{e:04d}" for e in range(1, epochs + 1)]:
            fail(f"{loss}: the 2-rank train_stats.txt holds {rows}")
        conf = Configuration.load(osp.join(folders[0], "configuration"))
        epoch = ckpt.latest_epoch(folders[0])
        if epoch is None or ckpt.latest_epoch(folders[1]) != epoch:
            fail(f"{loss}: checkpoints {epoch} and {ckpt.latest_epoch(folders[1])}")
        probe = sort_axes(load_dataset(CLASSES, "test_set",
                                       osp.join(project, data))[0][:8]).astype(np.float32)
        (r1, l1), (r2, l2) = [build_trainer_from_checkpoint(conf, f, epoch, "cuda")
                              .reconstruct(probe) for f in folders]
        np.testing.assert_allclose(r2, r1, **CKPT_BAR, err_msg=f"{loss} checkpoint")
        np.testing.assert_allclose(l2, l1, rtol=5e-3, err_msg=f"{loss} checkpoint loss")
        samples = epochs * (4 * 51 // 50) * 50
        two_s, one_s = max(r[loss]["s"] for r in two), want["s"]
        epoch_s = [max(r[loss]["epoch_s"][e] for r in two) for e in range(epochs)]
        numbers[loss] = {"2 ranks s": two_s, "1 process s": one_s,
                         "2 ranks samples/s": samples / two_s,
                         "1 process samples/s": samples / one_s,
                         "largest loss difference": max(
                             abs(a - b) for r in two
                             for a, b in zip(r[loss]["losses"], want["losses"])),
                         "checkpoint recon difference": float(np.abs(r2 - r1).max()),
                         "epoch s, 2 ranks / 1 process": [epoch_s, want["epoch_s"]],
                         "losses": want["losses"]}
        print(f"mesh training {loss} at {n_points} points ({smi}): {epochs} epochs of "
              f"{samples // epochs} samples at learning rate {lr or DEFAULT_LR}, 2 ranks on one card {two_s:.2f} s "
              f"({samples / two_s:.1f} samples/s), 1 process {one_s:.2f} s "
              f"({samples / one_s:.1f} samples/s), {one_s / two_s:.3f}x (stage walls; "
              f"epochs {[round(t, 4) for t in epoch_s]} s against "
              f"{[round(t, 4) for t in want['epoch_s']]} s); losses "
              f"{want['losses']}, largest difference "
              f"{numbers[loss]['largest loss difference']:.3e}; ranks bit-equal; "
              f"checkpoint reconstructions within "
              f"{numbers[loss]['checkpoint recon difference']:.3e}; launches a rank "
              f"{ {k: v for k, v in two[0][loss]['launches'].items() if v} }")
    ulp = {float(k): v for k, v in one["ulp_control"].items()}
    numbers["one ulp of input, largest relative epoch-loss change, by rate"] = ulp
    print(f"mesh training: one process's own sensitivity, chamfer: one ulp "
          f"of input moves its per-epoch losses by up to {ulp} relative (by learning "
          f"rate; the bar is {TRAIN_BAR['rtol']})")
    nccl = one["nccl"]
    print(f"NCCL phase: one process formed a one-rank NCCL group on cuda:0 "
          f"({nccl['backend']}); all_reduce_sum {nccl['all_reduce_sum']}, the "
          f"differentiable all-reduce forward {nccl['forward']} and backward "
          f"{nccl['backward']} returned their inputs. This shows that the NCCL group "
          "forms and the helpers drive it; it shows nothing across cards.")
    if nccl["backend"] is None or nccl["backend"][0] != "nccl" or not (
            nccl["all_reduce_sum"] and nccl["forward"] and nccl["backward"]):
        fail(f"the NCCL phase: {nccl}")
    return launches, {"mesh training": numbers}


def native_loader_check(project, data):
    """The native PLY batch loader against the python parser on the written
    tree: the same clouds, the native path counted, both timed."""
    from geometric_adv_tpu_torch import native
    from geometric_adv_tpu_torch.data import datasets

    if native.get_module() is None:
        fail(f"the native PLY loader did not build: {native.build_error}")
    files = sorted(datasets.files_in_subdirs(osp.join(project, data), ".ply"))
    before = dict(datasets.LOADS)
    t0 = time.time()
    fast = datasets.load_point_clouds_from_filenames(files)
    native_s = time.time() - t0
    t0 = time.time()
    slow = datasets.load_point_clouds_from_filenames(files, use_native=False)
    python_s = time.time() - t0
    if datasets.LOADS["native"] != before["native"] + 1:
        fail(f"the native loader did not serve the call: {datasets.LOADS}")
    if not (np.array_equal(fast[0], slow[0]) and list(fast[1]) == list(slow[1])
            and list(fast[2]) == list(slow[2])):
        fail("the native PLY loader disagrees with the python parser")
    print(f"native PLY loader: {len(files)} files of {fast[0].shape[1]} points in "
          f"{native_s:.4f} s, the python parser (8 threads) {python_s:.4f} s; "
          "clouds, model names and class ids equal")
    return {"native s": native_s, "python s": python_s}


def sparse_legs(project, ae, victim, counters, n_pairs):
    """run_attack --encoder_vjp sparse and dense (composed chamfer, 24 pairs
    a call, SPARSE_ITERS) on the chamfer victim: the sparse backward counted,
    the same final metrics within rtol 2e-4 / atol 1e-6; the first-step
    gradient and z at 2048 points; both at 250 pairs in one call."""
    from geometric_adv_tpu_torch.cli.verify_cuda import SPARSE_SCALED, sparse_vs_dense
    from geometric_adv_tpu_torch.models import sparse_encode

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(24, N_POINTS, 3).astype(np.float32) - 0.5).cuda()
    res = sparse_vs_dense(victim.model, x)
    print(f"sparse encoder VJP at [24, {N_POINTS}]: z bit-equal {res['z_equal']}, "
          f"gradient max abs diff {res['max_abs']:.3g} ({res['max_rel']:.3g} of its "
          f"largest entry; bar {SPARSE_SCALED}), elementwise at rtol 2e-5 / atol 1e-7 "
          f"{res['elementwise']}, ReLU mask flips {res['flips']}")
    if not (res["z_equal"] and res["max_rel"] <= SPARSE_SCALED
            and res["backward_calls"] == 1):
        fail(f"the sparse encoder VJP disagrees with dense autograd: {res}")
    grads = {}
    for impl in ("onehot", "onehot", "scatter"):
        sparse_encode.SCATTER_IMPL = impl
        xr = x.clone().requires_grad_(True)
        sparse_encode.make_sparse_encode(victim.model)(xr).sum().backward()
        grads.setdefault(impl, []).append(xr.grad)
    sparse_encode.SCATTER_IMPL = "onehot"
    scatter_diff = float((grads["scatter"][0] - grads["onehot"][0]).abs().max())
    print(f"sparse backward's return to point rows: onehot second run bit-equal "
          f"{torch.equal(*grads['onehot'])}; scatter (index_add_) from onehot "
          f"{scatter_diff:.3g}")
    if not torch.equal(*grads["onehot"]):
        fail("the onehot sparse backward is not bit-equal on a second run")
    rates, metrics, total = {}, {}, {}
    for vjp in ("sparse", "dense"):
        calls = sparse_encode.BACKWARD_CALLS
        out = f"attack_res_{vjp}"
        counts, stages = leg(f"{vjp} encoder VJP attack", counters, lambda: run_stages([
            attack_stage(project, ae, SPARSE_ITERS, out,
                         ["--encoder_vjp", vjp, "--chamfer_impl", "composed"])]),
            ("nn_distance_cuda", "chamfer_grad1_cuda"))
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        ran = sparse_encode.BACKWARD_CALLS - calls
        want = SPARSE_ITERS[0] * len(CLASSES) if vjp == "sparse" else 0
        if ran != want:
            fail(f"the {vjp} attack ran the sparse backward {ran} times, not {want}")
        impl = json.load(open(osp.join(project, ae, "eval", out, "attack_impl.json")))
        if (impl["encoder_vjp"], impl["encoder_vjp_path"]) != (vjp, vjp):
            fail(f"the {vjp} attack recorded encoder VJP flag {impl['encoder_vjp']}, "
                 f"path {impl['encoder_vjp_path']}")
        seconds = stages["run_attack"][0]
        rates[f"{vjp} attack pair-iters/s, 24 pairs a call"] = (
            n_pairs * SPARSE_ITERS[0] / seconds)
        metrics[vjp] = np.stack([
            np.load(osp.join(project, ae, "eval", out, c, "adversarial_metrics.npy"))
            for c in CLASSES])
        print(f"{vjp} encoder VJP attack: {rates[f'{vjp} attack pair-iters/s, 24 pairs a call']:.1f} "
              f"pair-iters/s ({n_pairs} pairs x {SPARSE_ITERS[0]} iterations in "
              f"{seconds:.2f} s, stage wall clock); sparse backward passes {ran}")
    err = np.abs(metrics["sparse"] - metrics["dense"])
    lim = SPARSE_ATOL + SPARSE_RTOL * np.abs(metrics["dense"])
    print(f"sparse vs dense final metrics after {SPARSE_ITERS[0]} iterations: max abs "
          f"diff {err.max():.3g}, max ratio to rtol {SPARSE_RTOL} / atol {SPARSE_ATOL} "
          f"{(err / lim).max():.3g}")
    # the trajectory at the JAX test's bar, where Adam has not yet carried
    # float32 noise into other steps; beside it, how far two dense runs
    # apart by one ulp of their sources drift over SPARSE_ITERS
    check_attack_vs_host(victim, "chamfer", 2, (30, 20), ref_device="cuda",
                         card_encode=sparse_encode.make_sparse_encode(victim.model),
                         card_kw=dict(chamfer_method="composed"),
                         ref_kw=dict(chamfer_method="composed"),
                         tol=(SPARSE_RTOL, SPARSE_ATOL))
    drift_control(project, ae, victim, metrics)
    for vjp in ("sparse", "dense"):
        model = victim.model
        encode = (sparse_encode.make_sparse_encode(model) if vjp == "sparse"
                  else model.encode)
        torch.cuda.reset_peak_memory_stats()
        calls = sparse_encode.BACKWARD_CALLS
        rates[f"{vjp} attack pair-iters/s, 250 pairs in one call"] = (
            attack_at_reference_batch(victim, f"{vjp} encoder VJP", encode=encode,
                                      chamfer_method="composed"))
        if (sparse_encode.BACKWARD_CALLS > calls) != (vjp == "sparse"):
            fail(f"the {vjp} attack at 250 pairs took the wrong encoder backward")
        print(f"{vjp} encoder VJP attack at 250 pairs: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rates, total


def drift_control(project, ae, victim, metrics):
    """The first class's 24 pairs attacked in process for SPARSE_ITERS:
    dense, sparse, and dense from sources one ulp away; prints how far the
    sparse run's final metrics and the nudged dense run's drift from the
    dense run's (the CLI's sparse/dense pair is printed above)."""
    from geometric_adv_tpu_torch.attack.core import attack_batch
    from geometric_adv_tpu_torch.cli.common import AttackContext
    from geometric_adv_tpu_torch.models import sparse_encode

    ctx = AttackContext(project, ae,
                        attack_pc_idx=f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy")
    src, tgt = ctx.class_attack_data(CLASSES[0], ctx.point_clouds, 2)
    tz = ctx.class_attack_data(CLASSES[0], ctx.latent_vectors, 2)[1]
    ref = ctx.class_attack_data(CLASSES[0], ctx.ae_loss, 2)[1].reshape(-1)
    model = victim.model
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    nudged = np.nextafter(src, np.float32(np.inf))
    runs = {}
    for name, encode, source in (
            ("dense", model.encode, src),
            ("sparse", sparse_encode.make_sparse_encode(model), src),
            ("dense, sources one ulp up", model.encode, nudged)):
        runs[name] = attack_batch(
            encode, model.decode, t(source), t(tz), t(tgt), t(ref), [1.0],
            num_iterations=SPARSE_ITERS[0], num_iterations_thresh=SPARSE_ITERS[1],
            chamfer_method="composed").metrics
    cli = np.abs(metrics["sparse"][0] - metrics["dense"][0]).max()
    print(f"drift after {SPARSE_ITERS[0]} iterations over {CLASSES[0]}'s {len(src)} "
          f"pairs, max abs diff of the final metrics from the dense run: sparse "
          f"{np.abs(runs['sparse'] - runs['dense']).max():.3g}, dense from sources one "
          f"ulp up {np.abs(runs['dense, sources one ulp up'] - runs['dense']).max():.3g} "
          f"(the CLI runs' sparse vs dense on that class: {cli:.3g})")


def precision_legs(project, ae, data, counters):
    """tst_ae and a 20/10 attack at --matmul_precision tensorfloat32 beside
    float32, then the same stages on the victim's weights computing in
    bfloat16 (``ae_dtype``): rates and the deviation from float32 printed;
    the TF32 flags are off again after each stage."""
    from geometric_adv_tpu_torch.cli import tst_ae
    from geometric_adv_tpu_torch.train import checkpoint as ckpt
    from geometric_adv_tpu_torch.train.config import Configuration

    rates, total = {}, {}
    ev = osp.join(project, ae, "eval")
    recon32 = np.load(osp.join(ev, "reconstructions_test_set_13l.npy"))
    bf16 = "log/autoencoder_victim_bf16"
    conf = Configuration.load(osp.join(project, ae, "configuration"))
    conf.ae_dtype = "bfloat16"
    conf.train_dir = osp.join(project, bf16)
    conf.save(osp.join(project, bf16, "configuration"))
    epoch = ckpt.latest_epoch(osp.join(project, ae))
    ckpt.save_checkpoint(osp.join(project, bf16), epoch,
                         ckpt.restore_checkpoint(osp.join(project, ae), epoch)["state_dict"])
    common = ["--project_dir", project, "--device", "cuda"]
    cases = (("float32", ae, []), ("tensorfloat32", ae, ["--matmul_precision", "tensorfloat32"]),
             ("bfloat16 victim", bf16, []))
    attack = {}
    for label, folder, flags in cases:
        out_eval = "eval" if folder == bf16 else f"eval_{label}"
        stages_list = [("tst_ae", tst_ae.main, common + [
            "--data_folder", data, "--train_folder", folder,
            "--output_folder_name", out_eval] + flags)]
        if folder == bf16:
            from geometric_adv_tpu_torch.cli import prepare_indices_for_attack

            stages_list.append(("prepare_indices_for_attack", prepare_indices_for_attack.main,
                                common + ["--ae_folder", folder, "--get_rand_idx", "1",
                                          "--get_latent_nn_idx", "1", "--get_chamfer_nn_idx",
                                          "1", "--num_instance_per_class", "4"]))
        out = f"attack_res_precision_{label.split()[0]}"
        stages_list.append(attack_stage(project, folder, (20, 10), out,
                                        ["--chamfer_impl", "composed", *flags]))
        counts, stages = leg(f"precision {label}", counters, lambda: run_stages(stages_list),
                             ("nn_distance_cuda", "chamfer_grad1_cuda"))
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail(f"the TF32 flags are on after the {label} stages")
        recon = np.load(osp.join(project, folder, out_eval, "reconstructions_test_set_13l.npy"))
        if not np.isfinite(recon).all():
            fail(f"non-finite reconstructions at {label}")
        attack[label] = np.stack([np.load(osp.join(
            project, folder, "eval", out, c, "adversarial_metrics.npy")) for c in CLASSES])
        seconds = stages["run_attack"][0]
        n = attack[label].shape[2]
        rates[f"{label} attack pair-iters/s (20 iterations)"] = n * len(CLASSES) * 20 / seconds
        rates[f"{label} tst_ae s"] = stages["tst_ae"][0]
        dev_recon = float(np.abs(recon - recon32).max())
        dev_metrics = float(np.max(np.abs(attack[label] - attack["float32"])
                                   / np.maximum(np.abs(attack["float32"]), 1e-12)))
        print(f"precision {label}: tst_ae {stages['tst_ae'][0]:.2f} s, reconstructions "
              f"max abs deviation from float32 {dev_recon:.3g}; 20/10 attack "
              f"{rates[f'{label} attack pair-iters/s (20 iterations)']:.1f} pair-iters/s, "
              f"metrics max relative deviation from float32 {dev_metrics:.3g}")
    return rates, total


def reference_ae_variables(seed, scope="autoencoder", enc=(64, 128, 128, 256, 128),
                           dec=(256, 256, 3 * N_POINTS)):
    """A reference-named victim (tests/test_import_tf.py:48-85's layout) at
    the full width: tflearn conv filters [1, 1, c_in, c_out], BN moving
    statistics, the decoder's FC layers and the epoch counter."""
    rng = np.random.RandomState(seed)
    v = {f"{scope}/epoch": np.float32(500.0)}
    c_in = 3
    for i, width in enumerate(enc):
        base = f"{scope}/encoder_conv_layer_{i}"
        v[f"{base}/W"] = (rng.randn(1, 1, c_in, width) / np.sqrt(c_in)).astype(np.float32)
        v[f"{base}/b"] = (rng.randn(width) * 0.1).astype(np.float32)
        bn = f"{base}_bnorm"
        v[f"{bn}/beta"] = (rng.randn(width) * 0.1).astype(np.float32)
        v[f"{bn}/gamma"] = (1 + rng.randn(width) * 0.1).astype(np.float32)
        v[f"{bn}/moving_mean"] = (rng.randn(width) * 0.1).astype(np.float32)
        v[f"{bn}/moving_variance"] = (0.5 + rng.rand(width)).astype(np.float32)
        c_in = width
    for j, width in enumerate(dec):
        base = f"{scope}/decoder_fc_{j}"
        v[f"{base}/W"] = (rng.randn(c_in, width) / np.sqrt(c_in)).astype(np.float32)
        v[f"{base}/b"] = (rng.randn(width) * 0.01).astype(np.float32)
        c_in = width
    return v


def reference_torch_state(kind, seed):
    """A reference-layout AtlasNet (``module.``-prefixed, Conv1d weights
    [c_out, c_in, 1], one SPHERE primitive, bottleneck 1024, hidden 512, 2
    extra layers) or FoldingNet checkpoint dict at the full width."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def dense(base, c_in, c_out, conv=True):
        shape = (c_out, c_in, 1) if conv else (c_out, c_in)
        sd[f"{base}.weight"] = torch.randn(shape, generator=gen) / c_in ** 0.5
        sd[f"{base}.bias"] = torch.randn(c_out, generator=gen) * 0.01

    def bn(base, c):
        sd[f"{base}.weight"] = 1 + torch.randn(c, generator=gen) * 0.1
        sd[f"{base}.bias"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{base}.running_mean"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{base}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{base}.num_batches_tracked"] = torch.tensor(100)

    if kind == "atlasnet":
        for i, (a, b) in enumerate(((3, 64), (64, 128), (128, 1024)), 1):
            dense(f"encoder.conv{i}", a, b)
            bn(f"encoder.bn{i}", b)
        for i in (1, 2):
            dense(f"encoder.lin{i}", 1024, 1024, conv=False)
            bn(f"encoder.bn{i + 3}", 1024)
        base = "decoder.decoder.0"
        dense(f"{base}.conv1", 3, 1024)
        bn(f"{base}.bn1", 1024)
        dense(f"{base}.conv2", 1024, 512)
        bn(f"{base}.bn2", 512)
        for i in range(2):
            dense(f"{base}.conv_list.{i}", 512, 512)
            bn(f"{base}.bn_list.{i}", 512)
        dense(f"{base}.last_conv", 512, 3)
        return {f"module.{k}": v for k, v in sd.items()}
    for i, (a, b) in enumerate(((12, 64), (64, 64), (64, 64), (64, 128), (128, 1024)), 1):
        dense(f"encoder.conv{i}", a, b)
        bn(f"encoder.bn{i}", b)
    dense("encoder.fc1", 1024, 512, conv=False)
    bn("encoder.bn6", 512)
    dense("encoder.fc2", 512, 512, conv=False)
    for fold, c0 in ((1, 514), (2, 515)):
        dense(f"decoder.fold{fold}.conv1", c0, 512)
        dense(f"decoder.fold{fold}.conv2", 512, 512)
        dense(f"decoder.fold{fold}.conv3", 512, 3)
    return {"epoch": 7, "model": sd, "optimizer": {}}


REFERENCE_CONFIG = (  # a reference configuration.txt's lines (src/autoencoder.py:62-73)
    ("n_input", [N_POINTS, 3]),
    ("encoder_args", {"n_filters": [64, 128, 128, 256, 128], "b_norm": True,
                      "b_norm_decay": 0.9}),
    ("decoder_args", {"layer_sizes": [256, 256, 3 * N_POINTS], "b_norm": False}),
    ("batch_size", 50), ("learning_rate", 0.0005), ("loss", "chamfer"),
    ("training_epochs", 500), ("class_names", CLASSES), ("object_class", ["13l"]),
    ("encoder", "encoder_with_convs_and_symmetry"), ("decoder", "decoder_with_fc_only"),
)


def import_leg(project, data, counters):
    """The importers at the full width: a reference-named victim mapped and
    written by the functions the CLI's ``--model ae`` branch runs, its
    configuration from a reference configuration.txt; tst_ae and a 20/10
    attack on it (K1, K3), its reconstructions against the same checkpoint
    on the host; reference-layout AtlasNet and FoldingNet checkpoints
    imported through the CLI and restored by tst_transfer; the CLI's TF
    branch exits non-zero with the ImportError message."""
    import importlib.util

    from geometric_adv_tpu_torch.cli import import_reference_ckpt, tst_transfer
    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack, tst_ae
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.import_tf import (
        map_reference_ae_variables,
        write_reference_ae,
    )
    from geometric_adv_tpu_torch.train.trainer import build_trainer_from_checkpoint

    ae = "log/autoencoder_imported"
    train_dir = osp.join(project, ae)
    txt = osp.join(project, "reference_configuration.txt")
    with open(txt, "w") as f:
        f.write("".join("%30s: %s\n" % kv for kv in REFERENCE_CONFIG))
    conf = Configuration.from_reference_txt(txt)
    conf.train_dir = train_dir
    conf.save(osp.join(train_dir, "configuration"))
    params, stats, epoch = map_reference_ae_variables(reference_ae_variables(seed=3))
    path = write_reference_ae(params, stats, train_dir, epoch, conf)
    print(f"imported a reference-named victim (epoch {epoch}) -> {path}")

    common = ["--project_dir", project, "--device", "cuda"]
    stages_list = [
        ("tst_ae", tst_ae.main, common + ["--data_folder", data, "--train_folder", ae]),
        ("prepare_indices_for_attack", prepare_indices_for_attack.main,
         common + ["--ae_folder", ae, "--get_rand_idx", "1", "--get_latent_nn_idx", "1",
                   "--get_chamfer_nn_idx", "1", "--num_instance_per_class", "4"]),
        attack_stage(project, ae, (20, 10), "attack_res", ["--chamfer_impl", "composed"]),
    ]
    refs = {}
    for kind in ("atlasnet", "foldingnet"):
        refs[kind] = osp.join(project, f"reference_{kind}.pth")
        torch.save(reference_torch_state(kind, seed=4), refs[kind])
        folder = f"log/{kind}_imported"
        stages_list += [
            (f"import_reference_ckpt {kind}", import_reference_ckpt.main,
             ["--project_dir", project, "--model", kind, "--reference_ckpt", refs[kind],
              "--train_folder", folder]),
            (f"tst_transfer {kind}", tst_transfer.main,
             common + ["--ae_folder", ae, "--ae_type", kind, "--train_folder", folder]),
        ]
    counts, stages = leg("import", counters, lambda: run_stages(stages_list),
                         ("nn_distance_cuda", "chamfer_grad1_cuda"))
    card = np.load(osp.join(train_dir, "eval", "reconstructions_test_set_13l.npy"))
    clouds = np.load(osp.join(train_dir, "eval", "point_clouds_test_set_13l.npy"))
    host = build_trainer_from_checkpoint(conf, train_dir, epoch, "cpu")
    want = host.get_reconstructions(clouds)
    err = float(np.abs(card - want).max())
    print(f"imported victim: reconstructions on the card vs the host max abs diff {err:.3g}")
    np.testing.assert_allclose(card, want, **RECON_TOL)
    for kind in ("atlasnet", "foldingnet"):
        loss = stages[f"tst_transfer {kind}"][1]["loss"]
        print(f"imported {kind}: test loss {loss:.6f}")
        if not np.isfinite(loss):
            fail(f"the imported {kind}'s test loss is not finite")
    # the card's machine has no tensorflow: the TF branch must stop with the
    # ImportError's message (where tensorflow exists, on the missing prefix)
    has_tf = importlib.util.find_spec("tensorflow") is not None
    argv = ["--project_dir", project, "--model", "ae", "--reference_ckpt",
            osp.join(project, "models.ckpt-500"), "--train_folder", "log/tf_branch"]
    try:
        import_reference_ckpt.main(argv)
        raised = None
    except Exception as e:  # noqa: BLE001 -- the error is the check's subject
        raised = e
    expected = (raised is not None if has_tf else isinstance(raised, ImportError)
                and "needs the `tensorflow` package" in str(raised))
    print(f"import_reference_ckpt --model ae (tensorflow {'present' if has_tf else 'absent'}): "
          f"{raised!r}")
    if not expected:
        fail(f"the CLI's TF branch ended with {raised!r}")
    return counts


def verify_cuda_stage(counters):
    """``python3 -m geometric_adv_tpu_torch.cli.verify_cuda`` as a stage; it
    must pass every check."""
    from geometric_adv_tpu_torch.cli import verify_cuda

    counts, rc = leg("verify_cuda", counters, lambda: verify_cuda.main([]),
                     ("nn_distance_cuda", "chamfer_loss_payloads_cuda",
                      "emd_sweep_block_cuda"))
    if rc != 0:
        fail(f"verify_cuda exited {rc}")
    return counts


# --- the latent-space attack and the pipeline runner ---------------------------
# the attack's bars between two implementations (tests/test_torch_attack_frozen.py),
# reported for the latent leg: at full width float32 rounding alone exceeds
# them (PERF.md §6), as the card's own runs from perturbed sources show. The
# leg holds each class's mean of each metric column at LATENT_MEAN_RTOL and
# proves the bar both ways in every run: the card's runs from perturbed
# sources (LATENT_PERTURBATIONS) must stay under it, and the same attack with
# a planted fault (the distance weight 150 -> LATENT_FAULT_WEIGHT) must not.
# 3% sits about halfway, on a log scale, between the perturbations' largest
# move (1.55%) and the fault's (7.28%) (PERF.md §6, PR 15). Where no
# critical point of the victim's max-pool parts the two clouds, the
# reconstructions are held elementwise at the attack's cloud bar.
LATENT_METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
LATENT_CLOUD_ATOL = 1e-5
LATENT_MEAN_RTOL = 0.03
PIPELINE_DIR = osp.join(WORK, "pipeline")
LATENT_ARTIFACTS = ("adversarial_metrics", "adversarial_pc_input", "adversarial_pc_recon")
LATENT_WEIGHT = 150.0
LATENT_FAULT_WEIGHT = 135.0
# one ulp up and down, and scaled by 1 +- 2^-20 and 1 +- 2^-19 (~1e-6, the
# size of the card's and the host's rounding difference in a float32 GEMM
# over 64-256 terms)
LATENT_PERTURBATIONS = (
    ("ulp up", lambda x: np.nextafter(x, np.float32(np.inf))),
    ("ulp down", lambda x: np.nextafter(x, np.float32(-np.inf))),
    *((f"x(1{k:+d}*2^-20)", lambda x, k=k: (x * np.float32(1 + k * 2.0 ** -20)).astype(np.float32))
      for k in (1, -1, 2, -2)),
)


def latent_within(got, want, name):
    """(share of entries within the attack's bar for artifact ``name``, the
    largest entry's distance in units of that bar)."""
    if name == "adversarial_metrics":
        lim = LATENT_METRIC_TOL["atol"] + LATENT_METRIC_TOL["rtol"] * np.abs(want)
    else:
        lim = LATENT_CLOUD_ATOL
    ratio = np.abs(got - want) / lim
    return float((ratio <= 1).mean()), float(ratio.max())


def latent_mean_rel(got, want):
    """Relative difference of each metric column's mean over a class's
    pairs: ``got``/``want`` are [W, pairs, 5] metrics."""
    g, w = got[0].mean(axis=0), want[0].mean(axis=0)
    return np.abs(g - w) / np.abs(w)


def latent_controls(project, ae, sel):
    """The latent attack on the card through the stage's runner and
    configuration, per class: from its sources (``base``), from each of
    ``LATENT_PERTURBATIONS`` of them, and from its sources with
    ``LATENT_FAULT_WEIGHT`` in place of the distance weight (``fault``).
    Not counted: it runs after the leg. Returns ({class: {"base",
    "perturbed", "fault"}}, the victim)."""
    import copy

    from geometric_adv_tpu_torch.attack.core import AttackRunner
    from geometric_adv_tpu_torch.cli.common import NN_IDX_DICT, AttackContext, restore_victim
    from geometric_adv_tpu_torch.utils.artifacts import load_data

    ctx = AttackContext(project, ae, attack_folder="latent_space_attack",
                        attack_pc_idx=sel, num_pc_for_attack=1)
    ctx.nn_idx = load_data(ctx.data_path, ctx.files,
                           [NN_IDX_DICT[ctx.conf.target_pc_idx_type]])
    if [float(w) for w in ctx.conf.dist_weight_list] != [LATENT_WEIGHT]:
        fail(f"the latent stage's distance weights {ctx.conf.dist_weight_list}")
    victim = restore_victim(ctx.conf, ctx.ae_dir, "cuda")
    runner = AttackRunner(victim.model, ctx.conf, "cuda", chamfer_impl="composed")
    conf = copy.deepcopy(ctx.conf)
    conf.dist_weight_list = [LATENT_FAULT_WEIGHT]
    faulty = AttackRunner(victim.model, conf, "cuda", chamfer_impl="composed")
    runs = {}
    for c in CLASSES:
        src, tgt = ctx.class_attack_data(c, ctx.point_clouds)
        _, latent = ctx.class_attack_data(c, ctx.latent_vectors)
        _, loss = ctx.class_attack_data(c, ctx.ae_loss)
        loss = loss.reshape(-1)
        runs[c] = {
            "base": runner.attack(src, latent, tgt, loss),
            "perturbed": [runner.attack(f(src), latent, tgt, loss)
                          for _, f in LATENT_PERTURBATIONS],
            "fault": faulty.attack(src, latent, tgt, loss),
        }
    return runs, victim


def latent_critical_moves(victim, card, host, card_recon, host_recon):
    """Where the card's and the host's adversarial clouds part by more than
    the cloud bar, whether a moved point is critical (an argmax of the
    victim's max-pool in either cloud): -> (points moved, pairs with a
    critical point moved, the largest reconstruction gap in those pairs,
    the largest in the others)."""
    crit = [victim.get_pre_symmetry_argmax(x)[0] for x in (card, host)]
    moved = np.abs(card - host).max(axis=-1) > LATENT_CLOUD_ATOL  # [pairs, n]
    gap = np.abs(card_recon - host_recon).reshape(len(card), -1).max(axis=1)
    hit = np.array([moved[i, np.union1d(crit[0][i], crit[1][i])].any()
                    for i in range(len(card))])
    return (int(moved.sum()), int(hit.sum()), float(gap[hit].max(initial=0.0)),
            float(gap[~hit].max(initial=0.0)))


def latent_leg(project, ae, counters):
    """run_attack as runner_pipeline's latent-space stage runs it
    (``--loss_adv_type latent --dist_weight_list 150.0``, into
    latent_space_attack), cut to 20/10 iterations and one source a class (6
    pairs), ``--chamfer_impl composed``; then get_dists_per_point and
    evaluate_attack on it. K1 and K3 must launch. The same run_attack on
    the host (plain versions; both draw the initial perturbation from the
    attack's own seeded CPU generator): each class's mean of each metric
    column within ``LATENT_MEAN_RTOL``. The bar is proven in the same run
    (``latent_controls``): the card's runs from perturbed sources stay
    within it of the card's own, and the attack with the planted fault
    falls outside it against the host's. In the pairs where no critical
    point parts the card's and the host's clouds, the reconstructions
    within ``LATENT_CLOUD_ATOL``. Printed: the share of metric and cloud
    entries within the attack's elementwise bars, card against host and
    under the perturbations. Returns the leg's counts."""
    from geometric_adv_tpu_torch.cli import evaluate_attack, get_dists_per_point, run_attack

    sel = f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy"
    common = ["--project_dir", project, "--ae_folder", ae, "--attack_pc_idx", sel]
    attack = common + ["--num_pc_for_attack", "1", "--num_pc_for_target", "2",
                       "--num_iterations", "20", "--num_iterations_thresh", "10",
                       "--loss_adv_type", "latent", "--dist_weight_list", str(LATENT_WEIGHT),
                       "--chamfer_impl", "composed"]
    counts, stages = leg("latent attack", counters, lambda: run_stages([
        ("run_attack", run_attack.main, attack + [
            "--device", "cuda", "--output_folder_name", "latent_space_attack"]),
        ("get_dists_per_point", get_dists_per_point.main, common + [
            "--device", "cuda", "--attack_folder", "latent_space_attack"]),
        ("evaluate_attack", evaluate_attack.main, common + [
            "--output_folder_name", "latent_space_attack"]),
    ]), ("nn_distance_cuda", "chamfer_grad1_cuda"))
    t0 = time.time()
    run_attack.main(attack + ["--device", "cpu", "--output_folder_name",
                              "latent_space_attack_host"])
    print(f"latent attack on the host: {time.time() - t0:.2f} s")
    runs, victim = latent_controls(project, ae, sel)
    ev = osp.join(project, ae, "eval")
    worst = {"card against host": 0.0, "perturbed against the card": 0.0,
             f"fault (weight {LATENT_FAULT_WEIGHT}) against host": 0.0}
    for c in CLASSES:
        out = {}
        for i, name in enumerate(LATENT_ARTIFACTS):
            card = np.load(osp.join(ev, "latent_space_attack", c, name + ".npy"))
            host = np.load(osp.join(ev, "latent_space_attack_host", c, name + ".npy"))
            if card.shape != host.shape or card.shape[:2] != (1, 6):
                fail(f"latent attack {c}/{name}: shapes {card.shape}, {host.shape}")
            if not np.isfinite(card).all():
                fail(f"latent attack {c}/{name}: non-finite values on the card")
            out[name] = card, host
            share, big = latent_within(card, host, name)
            control = [latent_within(p[i], runs[c]["base"][i], name)
                       for p in runs[c]["perturbed"]]
            print(f"latent attack {c}/{name}: card against host {share:.4f} of entries "
                  f"within the attack's bar, the largest {big:.3g} of it; the card's "
                  f"perturbed sources ({', '.join(n for n, _ in LATENT_PERTURBATIONS)}) "
                  f"{[(round(sh, 4), float(f'{w:.3g}')) for sh, w in control]}")
        moved, hit, gap_hit, gap_other = latent_critical_moves(
            victim, out["adversarial_pc_input"][0][0], out["adversarial_pc_input"][1][0],
            out["adversarial_pc_recon"][0][0], out["adversarial_pc_recon"][1][0])
        print(f"latent attack {c}: {moved} points part the card's and the host's clouds "
              f"beyond {LATENT_CLOUD_ATOL}; {hit} of 6 pairs move a critical point; the "
              f"largest reconstruction gap {gap_hit:.3g} in those pairs, {gap_other:.3g} "
              f"in the others")
        if gap_other > LATENT_CLOUD_ATOL:
            fail(f"latent attack {c}: reconstructions {gap_other:.3g} apart where no "
                 f"critical point moved (bar {LATENT_CLOUD_ATOL})")
        metrics = out["adversarial_metrics"]
        rel = {"card against host": latent_mean_rel(*metrics),
               "perturbed against the card": np.max(
                   [latent_mean_rel(p.metrics, runs[c]["base"].metrics)
                    for p in runs[c]["perturbed"]], axis=0),
               f"fault (weight {LATENT_FAULT_WEIGHT}) against host": latent_mean_rel(
                   runs[c]["fault"].metrics, metrics[1])}
        for k, v in rel.items():
            worst[k] = max(worst[k], float(v.max()))
            print(f"latent attack {c}: class means of the metric columns, {k}, relative "
                  f"{np.round(v, 7).tolist()} (bar {LATENT_MEAN_RTOL})")
        if not (rel["card against host"] <= LATENT_MEAN_RTOL).all():
            fail(f"the latent attack's {c} class means on the card disagree with the "
                 f"host's: relative {rel['card against host'].tolist()}")
    print(f"latent attack: the largest class-mean difference of any metric column "
          f"{ {k: float(f'{v:.4g}') for k, v in worst.items()} } (bar {LATENT_MEAN_RTOL})")
    if worst["perturbed against the card"] > LATENT_MEAN_RTOL:
        fail("the latent leg's bar lies inside the card's own noise under perturbed "
             f"sources: {worst['perturbed against the card']:.4g}")
    fault = worst[f"fault (weight {LATENT_FAULT_WEIGHT}) against host"]
    if fault <= LATENT_MEAN_RTOL:
        fail(f"the latent leg's bar does not see the planted fault (distance weight "
             f"{LATENT_WEIGHT} -> {LATENT_FAULT_WEIGHT}): {fault:.4g}")
    stats = open(osp.join(ev, "latent_space_attack/over_classes/eval_stats.txt")).read()
    if "over classes" not in stats:
        fail("the latent attack's eval_stats.txt is incomplete")
    print(f"latent attack (dist weight {LATENT_WEIGHT}, 20/10, 6 pairs a class): stages "
          f"{({k: round(v[0], 2) for k, v in stages.items()})}")
    return counts


# what an idle stage's process costs before its work: the interpreter, torch's
# import, the CUDA context, and the rest of cli/common's imports
STARTUP_PROBE = (
    "import time; t0 = time.time(); import torch; t1 = time.time(); "
    "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); t2 = time.time(); "
    "import geometric_adv_tpu_torch.cli.common; t3 = time.time(); "
    "print(t0, t1 - t0, t2 - t1, t3 - t2)")


def startup_probe():
    """One process that does nothing but start as a stage starts: -> {part:
    seconds}, the process's wall among them."""
    from geometric_adv_tpu_torch import runner_pipeline as rp

    spawned = time.time()
    out = subprocess.run([sys.executable, "-c", STARTUP_PROBE], env=rp.stage_env(),
                         capture_output=True, text=True, timeout=300, check=True)
    wall = time.time() - spawned
    t0, torch_s, cuda_s, common_s = (float(x) for x in out.stdout.split())
    parts = {"interpreter": t0 - spawned, "import torch": torch_s,
             "CUDA context": cuda_s, "rest of cli/common's imports": common_s,
             "process wall": wall}
    print(f"idle stage start-up (s): { {k: round(v, 3) for k, v in parts.items()} }")
    return parts


def pipeline_leg():
    """``python3 -m geometric_adv_tpu_torch.runner_pipeline quick`` in a fresh
    directory, as a user runs it: every stage's exit code 0 and ``PIPELINE
    COMPLETE``; ``runner_pipeline.check_artifacts`` (each file a later stage
    reads, with the JAX stages' shapes); the identity transfer's sanity
    checks for the four classes; the kernels each stage reported at its
    exit: K5 in train_ae (512 points: the fused loss), K1 and K3 or K5 in
    both attacks (their calibration chooses), K2 in the chamfer matrix
    (prepare_indices_for_attack) and in run_metro. Returns (launches summed
    over the stages, stage walls)."""
    from geometric_adv_tpu_torch import runner_pipeline as rp

    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    os.makedirs(PIPELINE_DIR)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "geometric_adv_tpu_torch.runner_pipeline", "quick"],
        cwd=PIPELINE_DIR, env=rp.stage_env(), capture_output=True, text=True,
        timeout=900)
    wall = time.time() - t0
    with open(osp.join(PIPELINE_DIR, "runner.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0 or "PIPELINE COMPLETE" not in proc.stdout:
        print(proc.stdout[-4000:] + proc.stderr[-4000:])
        fail(f"runner_pipeline quick exited {proc.returncode}")
    with open(osp.join(PIPELINE_DIR, rp.STAGES_RECORD)) as f:
        record = json.load(f)
    if [r["rc"] for r in record] != [0] * len(rp.STAGES):
        fail(f"runner_pipeline quick stage exit codes {[r['rc'] for r in record]}")
    problems = rp.check_artifacts("quick", PIPELINE_DIR)
    if problems:
        fail(f"runner_pipeline quick artifacts: {problems[:10]}")
    sanity = proc.stdout.count("identity sanity checks passed")
    if sanity != len(CLASSES):
        fail(f"the identity transfer passed its sanity checks {sanity} times, "
             f"not once a class ({len(CLASSES)})")
    launches = {}
    for r in record:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    by_stage = {}
    for r in record:
        by_stage.setdefault(r["module"], []).append(r["launches"])

    def launched(stage, *kernels, index=0):
        return all(by_stage[stage][index].get(k, 0) > 0 for k in kernels)

    if not launched("train_ae", "chamfer_loss_payloads_cuda"):
        fail(f"train_ae at 512 points did not launch K5: {by_stage['train_ae']}")
    for i in (0, 1):
        if not (launched("run_attack", "nn_distance_cuda", "chamfer_grad1_cuda", index=i)
                or launched("run_attack", "chamfer_loss_payloads_cuda", index=i)):
            fail(f"run_attack {i} launched neither K1 and K3 nor K5: "
                 f"{by_stage['run_attack'][i]}")
    for stage in ("prepare_indices_for_attack", "run_metro"):
        if not launched(stage, "nn_distance_values_cuda"):
            fail(f"{stage} did not launch K2: {by_stage[stage]}")
    walls = {f"{r['stage']:02d} {r['module']}": round(r["wall_s"], 2) for r in record}
    startups = [r["startup_s"] for r in record]
    if any(x is None for x in startups[1:]):  # make_synthetic_data has no cli/common
        fail(f"runner_pipeline quick: stages without a start-up report {startups}")
    print(f"runner_pipeline quick: {wall:.2f} s, {len(record)} stages, exit 0, PIPELINE "
          f"COMPLETE, {len(rp.artifact_contract('quick', 1))} artifacts checked, identity "
          f"sanity passed for {sanity} classes; stage walls (s) {walls}")
    print("runner_pipeline quick: launches by stage "
          f"{ {k: [{n: c for n, c in x.items() if c} for x in v] for k, v in by_stage.items()} }")
    print("runner_pipeline quick: start-up by stage (s; spawn to the end of cli/common's "
          f"imports) { {r['stage']: None if x is None else round(x, 2) for r, x in zip(record, startups)} }; "
          f"sum {sum(x for x in startups if x):.2f} s of {sum(r['wall_s'] for r in record):.2f}")
    print("runner_pipeline quick: peak device memory by stage (GiB) "
          f"{ {r['stage']: round((r['peak_device_bytes'] or 0) / 2**30, 3) for r in record} }")
    return launches, walls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir
    from geometric_adv_tpu_torch.ops import chamfer as ch
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier
    from geometric_adv_tpu_torch.ops import emd
    from geometric_adv_tpu_torch.ops import bn_relu as bn_op
    from geometric_adv_tpu_torch.ops.cuda import bn_relu as cu_bn
    from geometric_adv_tpu_torch.ops.cuda import build
    from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
    from geometric_adv_tpu_torch.ops.cuda import emd as cu_emd
    from geometric_adv_tpu_torch.transfer import metro

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
    records.update(hier_kernel_phase(cu, hier))
    # K4 and K8 (with its preparation) are on no path of the package (as in
    # the JAX package): their launch counts are the kernel phase's
    phase_counts = cu.launch_counts()
    print(f"kernel phase launches: {phase_counts}")
    records.update(emd_kernel_phase(cu_emd, emd))
    records.update(bn_relu_kernel_phase(cu_bn, bn_op))
    transfer_kernel_phase(cu, ch, metro, records)

    shutil.rmtree(WORK, ignore_errors=True)
    project = WORK
    make_shapenet_like_dir(osp.join(project, "data/synthetic"), CLASSES,
                           n_per_class=60, n_points=N_POINTS, seed=0)
    make_shapenet_like_dir(osp.join(project, "data/synthetic_1024"), CLASSES,
                           n_per_class=60, n_points=1024, seed=1)
    n_test = 6 * len(CLASSES)  # the 85/5/10 split of 60 clouds: 51/3/6
    n_pairs = len(CLASSES) * 4 * (len(CLASSES) - 1) * 2
    counters = (cu, cu_emd, cu_bn)
    launches = dict.fromkeys(KERNELS, 0)
    rates = {}

    # --- chamfer leg --------------------------------------------------------
    ae = "log/autoencoder_victim"
    from geometric_adv_tpu_torch.data import datasets

    loads = dict(datasets.LOADS)
    counts, stages = leg("chamfer", counters, lambda: run_stages(
        [train_stage(project, ae, "data/synthetic", N_POINTS, "chamfer", 2)]
        + attack_stages(project, ae, "data/synthetic", (500, 400))),
        ("nn_distance_cuda", "nn_distance_values_cuda", "chamfer_grad1_cuda",
         "bn_relu_forward_cuda", "bn_relu_backward_cuda"))
    launches = {k: launches[k] + counts[k] for k in launches}
    served = {k: datasets.LOADS[k] - loads[k] for k in loads}
    print(f"PLY loads in the chamfer leg by path: {served}")
    if served["native"] <= 0 or served["python"]:
        fail(f"the chamfer leg's datasets were not all parsed natively: {served}")
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
    exact_rate, clouds, exact, slice_idx = chamfer_matrix_rate(project, "data/synthetic")
    rates["chamfer matrix pair-evals/s"] = exact_rate
    rates["eval forward drift, chamfer 2048 (12 vs 4s, sweep, plain sweep)"] = (
        check_batch_invariance(victim, clouds, "chamfer 2048"))
    rates["reference-batch attack pair-iters/s"] = attack_at_reference_batch(victim)

    # --- the defenses on the chamfer victim's attack ------------------------
    # the victim's no-grad loss: K1 where it routes composed, K2 where fused
    fused_loss = ch._takes_fused(torch.empty(1, N_POINTS, 3, device="cuda"), "auto")
    counts, stages = leg("defense", counters, lambda: run_stages(
        defense_stages(project, ae)),
        ("nn_distance_values_cuda" if fused_loss else "nn_distance_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    if counts["emd_sweep_block_cuda"] or counts["emd_sweep_tiled_cuda"]:
        fail(f"the defense leg launched an EMD kernel: {counts}")
    check_defense_artifacts(project, ae, N_POINTS)
    check_defense_on_host(project, ae, victim)
    rates["defense stage seconds"] = {k: v[0] for k, v in stages.items()}
    rates["knn_point ms at [100, 2048^2], k 9"] = knn_time()
    rates["screened chamfer matrix pair-evals/s"] = screened_matrix_check(
        clouds, exact, exact_rate, slice_idx)
    del clouds, exact

    # --- the classifier on the chamfer victim's data, attack and defense ----
    counts, stages = leg("classifier", counters, lambda: run_stages(
        classifier_stages(project, ae)), ())
    launches = {k: launches[k] + counts[k] for k in launches}
    if any(counts.values()):
        fail(f"the classifier stages launched a chamfer or EMD kernel: {counts}")
    (rates["classifier train samples/s"], rates["classifier clouds/s at batch 250"],
     _) = check_classifier(project, ae, stages, n_test)
    rates["classifier stage seconds"] = {k: v[0] for k, v in stages.items()}
    # the attack on the targets the port's classifier labels correctly
    counts, stages = leg("correct-pred attack", counters, lambda: run_stages([
        attack_stage(project, ae, (20, 10), "attack_res_correct_pred",
                     ["--correct_pred_only", "1", "--chamfer_impl", "composed"])]),
        ("nn_distance_cuda", "chamfer_grad1_cuda"))
    launches = {k: launches[k] + counts[k] for k in launches}
    m = np.load(osp.join(project, ae, "eval/attack_res_correct_pred", CLASSES[0],
                         "adversarial_metrics.npy"))
    if m.shape != (1, n_pairs // len(CLASSES), 5) or not np.isfinite(m).all():
        fail(f"the correct-pred attack's metrics: {m.shape}")

    # --- transfer: AtlasNet and FoldingNet on the chamfer victim's attack ---
    watch = (cu.nn_distance_cuda, cu.chamfer_grad1_cuda, cu.nn_distance_values_cuda)
    counts, stages = leg("transfer", counters, lambda: run_stages(
        transfer_stages(project, ae), watch), ("nn_distance_cuda", "chamfer_grad1_cuda"))
    launches = {k: launches[k] + counts[k] for k in launches}
    for k in ("chamfer_loss_payloads_cuda", "emd_sweep_block_cuda", "emd_sweep_tiled_cuda"):
        if counts[k]:
            fail(f"{k} was launched in the transfer leg")
    transfer_rates = check_transfer(project, ae, stages, n_test)
    rates["AtlasNet train samples/s"] = transfer_rates["atlasnet"]
    rates["FoldingNet train samples/s"] = transfer_rates["foldingnet"]
    rates["transfer stage seconds"] = {k: v[0] for k, v in stages.items()}
    rates["knn_point share of a FoldingNet step"] = foldingnet_step_profile()

    # --- metro: AtlasNet's SQUARE meshes against the analytic ones (K2) ----
    counts, stages = leg("metro", counters, lambda: run_stages(
        metro_stages(project, ae), watch), ("nn_distance_values_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    rates["metro seconds per mesh pair"] = check_metro(project, stages, metro)

    # --- binary_search_attack, and a traced run_attack ----------------------
    # with gradients at 2048 points the attack's chamfer routes composed
    # (K1 + K3) unless the fused loss is forced on
    fused_attack = ch._fused_loss_supported(N_POINTS)
    counts = binary_search_check(
        project, ae, victim, counters,
        ("chamfer_loss_payloads_cuda",) if fused_attack
        else ("nn_distance_cuda", "chamfer_grad1_cuda"))
    launches = {k: launches[k] + counts[k] for k in launches}
    trace_dir = osp.join(project, "trace")
    counts, _ = leg("traced attack", counters, lambda: run_stages([
        attack_stage(project, ae, (20, 10), "attack_res_trace",
                     ["--trace_dir", trace_dir, "--chamfer_impl", "composed"])]),
        ("nn_distance_cuda", "chamfer_grad1_cuda"))
    launches = {k: launches[k] + counts[k] for k in launches}
    check_trace(trace_dir, ("nn_kernel", "grad1_kernel"))
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

    # --- the latent-space attack, as runner_pipeline runs it (K1, K3) ------
    counts = latent_leg(project, ae, counters)
    launches = {k: launches[k] + counts[k] for k in launches}

    # --- the native PLY loader, the sparse encoder VJP, the precision options,
    # the importers and verify_cuda, on the chamfer victim and its data ------
    from geometric_adv_tpu_torch.cli.common import restore_victim
    from geometric_adv_tpu_torch.train.config import Configuration

    rates["native PLY loader s"] = native_loader_check(project, "data/synthetic")
    victim = restore_victim(Configuration.load(osp.join(project, ae, "configuration")),
                            osp.join(project, ae), "cuda")
    mesh_counts, new_rates, reports = mesh_leg(project, ae, victim, smi)
    rates.update(new_rates)
    mesh_train_counts, new_rates = mesh_train_leg(project, smi, *reports)
    rates.update(new_rates)
    new_rates, sparse_counts = sparse_legs(project, ae, victim, counters, n_pairs)
    rates.update(new_rates)
    del victim
    new_rates, precision_counts = precision_legs(project, ae, "data/synthetic", counters)
    rates.update(new_rates)
    for counts in (mesh_counts, mesh_train_counts, sparse_counts, precision_counts,
                   import_leg(project, "data/synthetic", counters)):
        launches = {k: launches[k] + counts.get(k, 0) for k in launches}
    verify_cuda_stage(counters)  # checks against plain versions: not counted
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
    rates["eval forward drift, EMD 2048 (12 vs 4s, sweep, plain sweep)"] = (
        check_batch_invariance(victim, dataset_clouds(project), "EMD 2048"))
    seconds = stages["run_attack"][0]
    rates["EMD attack pair-iters/s"] = n_pairs * EMD_ITERS[0] / seconds
    print(f"EMD attack {rates['EMD attack pair-iters/s']:.1f} pair-iters/s "
          f"({n_pairs} pairs x {EMD_ITERS[0]} iterations in {seconds:.2f} s, "
          "stage wall clock)")
    rates["EMD attack pair-iters/s, 24 pairs in one call"] = attack_at_reference_batch(
        victim, "EMD", pairs=EMD_ATTACK_PAIRS, iters=10, ae_loss_type="emd")
    del victim
    torch.cuda.synchronize()

    # --- EMD at 1024 points (K6): training, then the stages with the attack --
    from geometric_adv_tpu_torch.cli import tst_ae

    ae = "log/autoencoder_emd_1024"
    data = "data/synthetic_1024"
    counts, stages = leg("EMD 1024", counters, lambda: run_stages([
        train_stage(project, ae, data, 1024, "emd", 2)]), ("emd_sweep_block_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    rates["EMD train samples/s (1024)"] = check_training(project, ae, 2,
                                                         stages["train_ae"])
    print(f"EMD attack leg at 1024 points: run_attack cut to {EMD_ITERS[0]}/"
          f"{EMD_ITERS[1]} iterations (the reference runs 500/400)")
    counts, stages = leg("EMD 1024 attack", counters, lambda: run_stages(
        attack_stages(project, ae, data, EMD_ITERS),
        watch=(cu_emd.emd_sweep_block_cuda, cu_emd.emd_sweep_tiled_cuda)),
        ("emd_sweep_block_cuda",))
    launches = {k: launches[k] + counts[k] for k in launches}
    in_attack = stages["run_attack"][2]
    if in_attack["emd_sweep_block_cuda"] <= 0 or in_attack["emd_sweep_tiled_cuda"]:
        fail(f"run_attack at 1024 points launched {in_attack}, not K6 alone")
    check_artifacts(project, ae, len(CLASSES), n_test, 1024)
    victim, _ = check_attack_effect(project, ae)
    check_attack_vs_host(victim, "emd", 1, (5, 3), dist="pert", n_points=1024)
    check_attack_vs_host(victim, "emd", 1, (5, 3), columns=(0, 3, 4), n_points=1024)
    seconds = stages["run_attack"][0]
    rates["EMD attack pair-iters/s (1024)"] = n_pairs * EMD_ITERS[0] / seconds
    print(f"EMD attack at 1024 points {rates['EMD attack pair-iters/s (1024)']:.1f} "
          f"pair-iters/s ({n_pairs} pairs x {EMD_ITERS[0]} iterations in {seconds:.2f} "
          f"s, stage wall clock; K6 launched {in_attack['emd_sweep_block_cuda']} times)")
    rates["EMD attack pair-iters/s (1024), 24 pairs in one call"] = (
        attack_at_reference_batch(victim, "EMD 1024", pairs=EMD_ATTACK_PAIRS, iters=10,
                                  n_points=1024, ae_loss_type="emd"))
    del victim
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

    # --- the pipeline runner's quick mode, one process a stage ---------------
    rates["idle stage start-up s"] = startup_probe()
    counts, rates["runner_pipeline quick stage seconds"] = pipeline_leg()
    launches = {k: launches[k] + counts.get(k, 0) for k in launches}

    for k in ("chamfer_grad1_vpu_cuda", "nn_direction_hier_cuda", "hier_prep_cuda"):
        launches[k] = phase_counts[k]
    print("launches over the legs (K4, K8 and its preparation: the kernel "
          f"phase's): {launches}")
    print("rates: " + json.dumps(rates))
    kernels = []
    for name, rec in records.items():
        if "bnm" in rec:
            b, n, m = rec.pop("bnm")
            bound_ms, bound_by, kind = kernel_bound(name, b, n, m, rec.pop("pairs", None),
                                                    rec.pop("zero_share", None))
            shape = f"[{b},{n},3]x[{b},{m},3]"
        else:  # the fused batch norm + ReLU: its bytes over a step's five layers
            shape, bound_ms = rec.pop("shape"), rec.pop("bound_ms")
            bound_by = kind = "bytes"
        rec.setdefault("ms_by", EVENT_TIME)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "shape": shape, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_type": kind, "library_ms": None, **rec})
        print(f"kernel {name} at {shape}: {rec['ms']:.4f} ms "
              f"({rec['ms_by']}), bound "
              f"{bound_ms:.4f} ms ({kind}), {100 * bound_ms / rec['ms']:.1f}% of the bound; "
              + (f"plain {rec['plain_ms']:.4f} ms; " if "plain_ms" in rec else "")
              + f"{launches[name]} launches over the legs")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2:]))
    sys.exit(main())
