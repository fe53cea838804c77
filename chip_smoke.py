#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``geometric_adv_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each followed by ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero:

1. print the card's name and power limit, pin float32 matmuls (no TF32);
2. build the hand-written CUDA kernels from ``geometric_adv_tpu_torch/csrc``;
3. kernel phase: each kernel's wrapper against its plain PyTorch version on
   the card at the main path's shapes ([64, 2048, 3] clouds, and a ragged
   2000 x 2048 case), with exact ties in the inputs — K1 and K2 values
   bit-equal and K1 indices equal, K3 within 2.6e-6 — and both timed;
4. main path: a synthetic dataset (sphere cube torus cone, 60 per class,
   2048 points) and a full-width victim from a seeded generator, then the
   port's stage CLIs on ``--device cuda``: tst_ae, prepare_indices_for_attack
   (all three index kinds), run_attack (500/400 iterations),
   get_dists_per_point, evaluate_attack. Launch counts are zeroed just
   before and read just after; every kernel must have launched;
5. output checks: every artifact present with the JAX stages' shapes and
   finite, the attack lowers the mean target reconstruction error, and the
   attack on the card agrees with the same attack on the host CPU (plain
   versions) on a small input;
6. rates: attack pair-iterations/s of the main path and at the
   reference's batch of 250 pairs (with a torch.profiler breakdown), and
   the chamfer matrix's pair-evaluations/s over the 240 dataset clouds.

Its last lines are a JSON record of the kernels, the card as nvidia-smi
reports it, and ``{"ok": true, "device": {...}}``. It writes only under
``build/chip_smoke/`` in the checkout.
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
CSRC = "geometric_adv_tpu_torch/csrc/"


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


def kernel_phase(cu, ch):
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


def main_path(project):
    """The port's stages through their CLIs; returns per-stage seconds."""
    from geometric_adv_tpu_torch.cli import evaluate_attack, get_dists_per_point
    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack, run_attack
    from geometric_adv_tpu_torch.cli import tst_ae

    ae = "log/autoencoder_victim"
    sel = f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy"
    common = ["--project_dir", project]
    dev = ["--device", "cuda"]
    stages = [
        ("tst_ae", tst_ae.main,
         common + dev + ["--data_folder", "data/synthetic", "--train_folder", ae]),
        ("prepare_indices_for_attack", prepare_indices_for_attack.main,
         common + dev + ["--ae_folder", ae, "--get_rand_idx", "1",
                         "--get_latent_nn_idx", "1", "--get_chamfer_nn_idx", "1",
                         "--num_instance_per_class", "4"]),
        ("run_attack", run_attack.main,
         common + dev + ["--ae_folder", ae, "--attack_pc_idx", sel,
                         "--num_pc_for_attack", "4", "--num_pc_for_target", "2"]),
        ("get_dists_per_point", get_dists_per_point.main,
         common + dev + ["--ae_folder", ae, "--attack_pc_idx", sel]),
        ("evaluate_attack", evaluate_attack.main,
         common + ["--ae_folder", ae, "--attack_pc_idx", sel]),
    ]
    seconds = {}
    for name, fn, argv in stages:
        t0 = time.time()
        fn(argv)
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        print(f"stage {name}: {seconds[name]:.2f} s")
    return seconds


def check_artifacts(project, n_classes, n_test):
    """Shapes of the JAX stages' artifacts, all finite."""
    ev = osp.join(project, "log/autoencoder_victim/eval")
    pairs = 4 * (n_classes - 1) * 2
    want = {
        "point_clouds_test_set_13l.npy": (n_test, N_POINTS, 3),
        "latent_vectors_test_set_13l.npy": (n_test, 128),
        "reconstructions_test_set_13l.npy": (n_test, N_POINTS, 3),
        "ae_loss_test_set_13l.npy": (n_test,),
        "slice_idx_test_set_13l.npy": (n_classes + 1,),
        "pc_label_test_set_13l.npy": (n_test,),
        "pc_classes_13l.npy": (n_classes,),
        "sel_idx_rand_4_test_set_13l.npy": (n_classes, 4),
        "latent_nn_idx_test_set_13l.npy": (n_test, n_test),
        "chamfer_dist_mat_complete_test_set_13l.npy": (n_test, n_test),
        "chamfer_nn_idx_complete_test_set_13l.npy": (n_test, n_test),
    }
    for c in CLASSES:
        want.update({
            f"attack_res/{c}/adversarial_metrics.npy": (1, pairs, 5),
            f"attack_res/{c}/adversarial_pc_input.npy": (1, pairs, N_POINTS, 3),
            f"attack_res/{c}/adversarial_pc_recon.npy": (1, pairs, N_POINTS, 3),
            f"attack_res/{c}/adversarial_pc_input_dists.npy": (1, pairs, N_POINTS),
            f"attack_res/{c}/dist_weight.npy": (1,),
            f"attack_res/{c}/analysis_results/source_target_norm_min_idx.npy":
                (pairs,),
        })
    for rel, shape in want.items():
        a = np.load(osp.join(ev, rel))
        if a.shape != shape:
            fail(f"{rel}: shape {a.shape}, expected {shape}")
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            fail(f"{rel}: non-finite values")
    stats = open(osp.join(ev, "attack_res/over_classes/eval_stats.txt")).read()
    if "over classes" not in stats or "S-CD" not in stats:
        fail("eval_stats.txt is incomplete")
    print(f"artifacts: {len(want)} checked (shapes, finite), eval_stats.txt "
          "complete")


def check_attack_effect(project):
    """Mean best T-RE of the attack vs the mean T-RE of the clean sources
    against the same targets."""
    from geometric_adv_tpu_torch.cli.common import AttackContext, restore_victim
    from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc

    ae = "log/autoencoder_victim"
    ctx = AttackContext(project, ae, attack_folder="attack_res",
                        attack_pc_idx=f"{ae}/eval/sel_idx_rand_4_test_set_13l.npy")
    victim = restore_victim(ctx.conf, ctx.ae_dir, "cuda")
    best, clean = [], []
    for _, name in ctx.classes_iter():
        src, tgt = ctx.class_attack_data(name, ctx.point_clouds)
        recon = victim.get_reconstructions(src)
        with torch.no_grad():
            clean.append(chamfer_loss_per_pc(
                torch.from_numpy(recon).cuda(), torch.from_numpy(tgt).cuda()
            ).cpu().numpy())
        m = np.load(osp.join(ctx.attack_dir, name, "adversarial_metrics.npy"))
        best.append(m[0, :, 4])
    best_mean = float(np.mean(np.concatenate(best)))
    clean_mean = float(np.mean(np.concatenate(clean)))
    print(f"attack effect: mean best T-RE {best_mean:.6f} vs clean sources "
          f"{clean_mean:.6f}")
    if not best_mean < clean_mean:
        fail("the attack did not lower the mean target reconstruction error")
    return victim


def check_attack_vs_host(victim):
    """The attack on the card (kernels) against the same attack on the host
    CPU (plain versions), 2 pairs x 2048 points, 30 iterations. Tolerance
    rtol 1e-3 / atol 1e-5 on the metrics: the card's and the host's BLAS sum
    the victim's matmuls in different orders, and 30 Adam steps carry that
    difference forward."""
    import copy

    from geometric_adv_tpu_torch.attack.core import attack_batch

    rng = np.random.RandomState(7)
    x = rng.rand(2, N_POINTS, 3).astype(np.float32) - 0.5
    gt = rng.rand(2, N_POINTS, 3).astype(np.float32) - 0.5
    ref = np.ones(2, np.float32)
    pert0 = (rng.randn(2, N_POINTS, 3) * 1e-7).astype(np.float32)
    outs = {}
    for dev, model in (("cuda", victim.model),
                       ("cpu", copy.deepcopy(victim.model).cpu())):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.no_grad():
            tz = model.encode(t(gt))
        outs[dev] = attack_batch(
            model.encode, model.decode, t(x), tz, t(gt), t(ref), [1.0, 3.0],
            num_iterations=30, num_iterations_thresh=20, pert0=t(pert0),
        )
    err = np.abs(outs["cuda"].metrics - outs["cpu"].metrics)
    lim = 1e-5 + 1e-3 * np.abs(outs["cpu"].metrics)
    print(f"attack card vs host: metrics max abs diff {err.max():.3g}, "
          f"max ratio to tolerance {(err / lim).max():.3g}")
    if not (err <= lim).all():
        fail("the attack on the card disagrees with the host's plain run")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from geometric_adv_tpu_torch.data.datasets import load_point_clouds_under_folder
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir
    from geometric_adv_tpu_torch.ops import chamfer as ch
    from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    cu.load_library()
    print(f"build: {time.time() - t0:.2f} s into {cu.library_path()}")
    ptxas = [ln for ln in cu.build_log.splitlines() if "Used" in ln]
    for ln in ptxas:
        print(f"  {ln.strip()}")

    records = kernel_phase(cu, ch)

    shutil.rmtree(WORK, ignore_errors=True)
    project = WORK
    make_shapenet_like_dir(osp.join(project, "data/synthetic"), CLASSES,
                           n_per_class=60, n_points=N_POINTS, seed=0)
    train_dir = osp.join(project, "log/autoencoder_victim")
    conf = Configuration(n_input=[N_POINTS, 3], bneck_size=128,
                         class_names=list(CLASSES), train_dir=train_dir)
    conf.save(osp.join(train_dir, "configuration"))
    AETrainer(conf, "cuda", seed=0).save(train_dir, 1)

    cu.reset_launch_counts()
    seconds = main_path(project)
    torch.cuda.synchronize()
    launches = cu.launch_counts()
    print(f"launches on the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the main path")

    n_test = 6 * len(CLASSES)  # the 85/5/10 split of 60 clouds: 51/3/6
    check_artifacts(project, len(CLASSES), n_test)
    victim = check_attack_effect(project)
    check_attack_vs_host(victim)
    torch.cuda.synchronize()

    n_pairs = len(CLASSES) * 4 * (len(CLASSES) - 1) * 2
    attack_rate = n_pairs * 500 / seconds["run_attack"]
    clouds = np.concatenate([
        load_point_clouds_under_folder(osp.join(project, "data/synthetic", c))
        for c in CLASSES
    ])
    chamfer_distance_matrix(clouds[:8], "cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    chamfer_distance_matrix(clouds, "cuda")
    torch.cuda.synchronize()
    matrix_pairs = len(clouds) * (len(clouds) + 1) // 2
    matrix_rate = matrix_pairs / (time.time() - t0)
    print(f"rates: attack {attack_rate:.1f} pair-iters/s ({n_pairs} pairs x "
          f"500 iterations in {seconds['run_attack']:.2f} s, stage wall "
          f"clock); chamfer matrix {matrix_rate:.1f} pair-evals/s "
          f"({matrix_pairs} pairs of {N_POINTS}-point clouds)")
    attack_at_reference_batch(victim)
    torch.cuda.synchronize()

    source = {"nn_distance_cuda": CSRC + "nn_distance.cu",
              "nn_distance_values_cuda": CSRC + "nn_distance.cu",
              "chamfer_grad1_cuda": CSRC + "chamfer_grad.cu"}
    replaces = {
        "nn_distance_cuda": "geometric_adv_tpu/ops/pallas/chamfer_kernel_v2.py:258",
        "nn_distance_values_cuda":
            "geometric_adv_tpu/ops/pallas/chamfer_kernel_v2.py:194",
        "chamfer_grad1_cuda":
            "geometric_adv_tpu/ops/pallas/chamfer_bwd_kernel.py:298",
    }
    kernels = [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": launches[name], **rec}
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
