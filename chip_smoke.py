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
   the card at the main path's shapes, both timed (CUDA events):
   - K1/K2/K3 at [64, 2048, 3] clouds and a ragged 2000 x 2048 case, with
     exact ties: K1 and K2 values bit-equal and K1 indices equal, K3 within
     2.6e-6;
   - K6/K7 (the EMD sweep) at [50, 1024^2] (K6, K7 and each other),
     [50, 2048^2] (K7) and the ragged [8, 1024 x 512], [8, 500 x 1000]:
     cost rtol 1e-5, gradients atol 1e-4 * max|g|, in grads mode with and
     without g2 and value-only, whose cost must be bit-equal;
4. three legs through the port's stage CLIs on ``--device cuda``, each with
   the launch counts zeroed just before and read just after:
   - chamfer: ``train_ae --loss chamfer`` (2048 points, 2 epochs), tst_ae,
     prepare_indices_for_attack (all three index kinds), run_attack
     (500/400 iterations), get_dists_per_point, evaluate_attack; K1, K2 and
     K3 must launch;
   - EMD: ``train_ae --loss emd`` (2048 points, batch 50, 3 epochs), then the
     same stages with run_attack cut to 100/80 iterations; K7 and K2 must
     launch;
   - EMD at 1024 points: ``train_ae --loss emd --n_points 1024`` (2 epochs)
     and tst_ae; K6 must launch;
   all on a synthetic dataset of sphere, cube, torus and cone, 60 clouds each;
5. output checks per leg: every artifact has the JAX stages' shape and is
   finite, the training loss falls, the attack lowers the mean target
   reconstruction error, and the attack on the card agrees with the same
   attack on the host CPU (plain versions) on a small input: all metrics for
   chamfer, and for the EMD victim with the perturbation-norm distance; the
   target-reconstruction metrics with the EMD distance;
6. rates: train samples/s per leg, attack pair-iterations/s of both attack
   legs and at the reference's batch of 250 pairs (with a torch.profiler
   breakdown), the chamfer matrix's pair-evaluations/s, and the peak device
   memory of each leg.

Its last lines are a JSON record of the kernels, the card as nvidia-smi
reports it, and ``{"ok": true, "device": {...}}``. It writes only under
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

ROOT = osp.dirname(osp.abspath(__file__))
WORK = osp.join(ROOT, "build", "chip_smoke")
CLASSES = ["sphere", "cube", "torus", "cone"]
N_POINTS = 2048
GRAD_TOL = 2.6e-6  # DESIGN.md section 6 gradient bar
EMD_COST_RTOL = 1e-5  # geometric_adv_tpu/cli/verify_tpu.py:482
EMD_GRAD_REL = 1e-4
EMD_ITERS = (100, 80)  # the EMD leg's attack, cut from the reference 500/400
CSRC = "geometric_adv_tpu_torch/csrc/"
PALLAS = "geometric_adv_tpu/ops/pallas/"
KERNELS = {  # wrapper: (source, the TPU kernel it replaces)
    "nn_distance_cuda": (CSRC + "nn_distance.cu", PALLAS + "chamfer_kernel_v2.py:258"),
    "nn_distance_values_cuda": (CSRC + "nn_distance.cu",
                                PALLAS + "chamfer_kernel_v2.py:194"),
    "chamfer_grad1_cuda": (CSRC + "chamfer_grad.cu", PALLAS + "chamfer_bwd_kernel.py:298"),
    "emd_sweep_block_cuda": (CSRC + "emd_sweep.cu", PALLAS + "emd_fused_kernel.py:179"),
    "emd_sweep_tiled_cuda": (CSRC + "emd_sweep.cu", PALLAS + "emd_round_kernel.py:268"),
}


def fail(msg: str):
    raise RuntimeError(msg)


def sync_timed(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tie_clouds(b, n, m, seed):
    """Seeded uniform clouds with exact ties: a duplicated point in each
    cloud and a query point that coincides with a point of the other."""
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x2[:, 5] = x2[:, 17]
    x1[:, 9] = x1[:, 40]
    x1[:, 3] = x2[:, 7]
    return torch.from_numpy(x1).cuda(), torch.from_numpy(x2).cuda()


def chamfer_kernel_phase(cu, ch):
    """K1/K2/K3 against their plain versions; returns the kernel records."""
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
        print(f"kernel check {shape}: K1 values+indices bit-equal, K2 "
              f"bit-equal, K3 max abs err {k3_err:.3g} (tol {GRAD_TOL})")
        if n == m:  # time at the main-path shape
            k1_err = max((d1 - r1).abs().max().item(), (d2 - r2).abs().max().item())
            k2_err = max((v1 - r1).abs().max().item(), (v2 - r2).abs().max().item())
            timings = {
                "nn_distance_cuda": (
                    k1_err,
                    sync_timed(lambda: cu.nn_distance_cuda(x1, x2), 20),
                    sync_timed(lambda: ch.nn_distance_plain(x1, x2), 5),
                ),
                "nn_distance_values_cuda": (
                    k2_err,
                    sync_timed(lambda: cu.nn_distance_values_cuda(x1, x2), 20),
                    sync_timed(lambda: ch.nn_distance_values_plain(x1, x2), 5),
                ),
                "chamfer_grad1_cuda": (
                    k3_err,
                    sync_timed(lambda: cu.chamfer_grad1_cuda(
                        x1, x2, i1, i2, g1, g2), 20),
                    sync_timed(lambda: ch.chamfer_grad1_plain(
                        x1, x2, i1, i2, g1, g2), 5),
                ),
            }
            for name, (err, ms, plain_ms) in timings.items():
                records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
                print(f"  {name} at {shape}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms")
        del x1, x2, d1, i1, d2, i2, r1, j1, r2, j2, v1, v2, k3, p3
    torch.cuda.synchronize()
    return records


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
    bit-equal to grads mode; times at the main path's shapes (mean of 10
    kernel calls and 3 plain calls) in its mode, g1 only."""
    kernels = {"K6": cu_emd.emd_sweep_block_cuda, "K7": cu_emd.emd_sweep_tiled_cuda}
    records = {}
    for b, n, m, names in ((8, 1024, 512, "K6 K7"), (8, 500, 1000, "K6 K7"),
                           (50, 1024, 1024, "K6 K7"), (50, N_POINTS, N_POINTS, "K7")):
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
            outs[name] = full
            print(f"kernel check {name} {shape}: cost rel {worst[0]:.3g} (tol "
                  f"{EMD_COST_RTOL}), grads {worst[1]:.3g} of max|g| (tol "
                  f"{EMD_GRAD_REL}), value-only cost bit-equal")
            main_shape = (b == 50 and n == (1024 if name == "K6" else N_POINTS))
            if main_shape:
                wrapper = fn.__name__
                ms = sync_timed(lambda: fn(x, y, emd._LEVELS, True, False), 10)
                plain_ms = sync_timed(lambda: emd.emd_sweep_plain(x, y, True, False), 3)
                records[wrapper] = {"max_abs_err": worst[2], "ms": ms,
                                    "plain_ms": plain_ms}
                print(f"  {wrapper} at {shape}, g1 only: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms")
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


def attack_stages(project, ae, data, iters):
    from geometric_adv_tpu_torch.cli import evaluate_attack, get_dists_per_point
    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack, run_attack
    from geometric_adv_tpu_torch.cli import tst_ae

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
        ("run_attack", run_attack.main,
         common + dev + ["--ae_folder", ae, "--attack_pc_idx", sel,
                         "--num_pc_for_attack", "4", "--num_pc_for_target", "2",
                         "--num_iterations", str(iters[0]),
                         "--num_iterations_thresh", str(iters[1])]),
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


def check_attack_effect(project, ae):
    """Mean best T-RE of the attack vs the mean T-RE of the clean sources
    against the same targets, in the victim's own loss."""
    from geometric_adv_tpu_torch.cli.common import AttackContext, restore_victim
    from geometric_adv_tpu_torch.train.trainer import reconstruction_loss_per_pc

    ctx = AttackContext(project, ae, attack_folder="attack_res",
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
    print(f"attack effect ({ctx.conf.loss} victim): mean best T-RE "
          f"{best_mean:.6f} vs clean sources {clean_mean:.6f}")
    if not best_mean < clean_mean:
        fail("the attack did not lower the mean target reconstruction error")
    return victim


def check_attack_vs_host(victim, loss, pairs, iters, dist="chamfer",
                         columns=(0, 1, 2, 3, 4)):
    """The attack on the card (kernels) against the same attack on the host
    CPU (plain versions), ``pairs`` x 2048 points at two dist weights.
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
    for dev, model in (("cuda", victim.model),
                       ("cpu", copy.deepcopy(victim.model).cpu())):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.no_grad():
            tz = model.encode(t(gt))
        outs[dev] = attack_batch(
            model.encode, model.decode, t(x), tz, t(gt), t(ref), [1.0, 3.0],
            num_iterations=iters[0], num_iterations_thresh=iters[1],
            ae_loss_type=loss, loss_dist_type=dist, pert0=t(pert0),
        )
    err = np.abs(outs["cuda"].metrics - outs["cpu"].metrics)
    lim = 1e-5 + 1e-3 * np.abs(outs["cpu"].metrics)
    held = list(columns)
    rel = err / np.abs(outs["cpu"].metrics)
    print(f"{loss} attack, loss_dist_type {dist}, card vs host ({pairs} pairs, "
          f"{iters[0]} iterations): columns {held} max abs diff "
          f"{err[..., held].max():.3g}, max ratio to tolerance "
          f"{(err / lim)[..., held].max():.3g}; relative diff per column "
          f"{np.round(rel.max(axis=(0, 1)), 7).tolist()}")
    if not (err <= lim)[..., held].all():
        fail(f"the {loss} attack on the card disagrees with the host's plain run")


def attack_at_reference_batch(victim, pairs=250, iters=20):
    """Attack pair-iterations/s at the reference's attack batch (250 pairs
    of 2048-point clouds), then a torch.profiler breakdown of 5 iterations:
    device time by kernel and the device's busy share of the wall clock."""
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
                            num_iterations=n_iter, num_iterations_thresh=1)

    run(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    run(iters)
    torch.cuda.synchronize()
    rate = pairs * iters / (time.time() - t0)
    print(f"attack at the reference batch: {rate:.1f} pair-iters/s "
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
    print(f"profile of 5 iterations: device busy {busy_us / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * busy_us / wall_us:.1f}%)")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {100 * us / busy_us:5.1f}%  {us / 1e3:8.3f} ms  x{count:<5d} "
              f"{key[:240]}")
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

    records = chamfer_kernel_phase(cu, ch)
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
    victim = check_attack_effect(project, ae)
    check_attack_vs_host(victim, "chamfer", 2, (30, 20))
    seconds = stages["run_attack"][0]
    rates["chamfer attack pair-iters/s"] = n_pairs * 500 / seconds
    print(f"chamfer attack {rates['chamfer attack pair-iters/s']:.1f} pair-iters/s "
          f"({n_pairs} pairs x 500 iterations in {seconds:.2f} s, "
          "stage wall clock)")
    rates["chamfer matrix pair-evals/s"] = chamfer_matrix_rate(project, "data/synthetic")
    rates["reference-batch attack pair-iters/s"] = attack_at_reference_batch(victim)
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
    victim = check_attack_effect(project, ae)
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

    print(f"launches over the three legs: {launches}")
    print("rates: " + json.dumps(rates))
    kernels = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name], **rec}
        for name, rec in records.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
