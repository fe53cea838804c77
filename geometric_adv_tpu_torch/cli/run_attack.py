"""Run the geometric adversarial attack (``geometric_adv_tpu/cli/run_attack.py``;
reference: attacker/run_attack.py).

Per source class: assemble the source/target pair grid, run the attack over
all dist weights, save the per-class artifacts (adversarial_metrics /
_pc_input / _pc_recon / dist_weight). The victim's ``conf.loss`` (chamfer or
EMD) selects the attack's losses. ``--chamfer_impl fused|composed`` forces
the chamfer route (else the runner calibrates on the card) and
``--chamfer_refresh N`` runs the frozen-assignment mode; the runner's
routing is written to ``attack_impl.json``. ``--encoder_vjp sparse``
differentiates the victim's encoder through the argmax-sparse VJP
(``models/sparse_encode.py``); ``auto`` is dense on the CPU and the card.
``--matmul_precision`` sets the float32 matmuls' precision for this stage
(``cli/common.py::resolve_device``). Flags keep the JAX stage's names.
``--use_mesh 1`` (the default) shards each attack call's pairs over the
processes when several are up (``GAT_*`` variables, ``cli/common.py``;
one process per card); the primary alone writes the artifacts, and every
rank passes a barrier before it exits. ``attack_impl.json`` records the
flags' values, and, under port-only keys, the path the encoder's VJP took,
the batch, the device and the process count.
``--trace_dir`` writes a torch.profiler trace of the first class's attack
on the primary (``utils/profiling.py``)."""

import argparse
import contextlib
import json
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.attack.core import AttackRunner, _auto_dispatch_batch
from geometric_adv_tpu_torch.cli.common import (
    NN_IDX_DICT,
    AttackContext,
    add_device_flag,
    ensure_dir,
    resolve_device,
    restore_victim,
    restored_tf32_flags,
)
from geometric_adv_tpu_torch.parallel import barrier, get_mesh, is_primary
from geometric_adv_tpu_torch.utils.artifacts import load_data
from geometric_adv_tpu_torch.utils.profiling import trace


def main(argv=None):
    with restored_tf32_flags():
        return _run(argv)


def _run(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--learning_rate", type=float, default=0.01)
    parser.add_argument("--loss_dist_type", type=str, default="chamfer",
                        choices=["pert", "chamfer"])
    parser.add_argument("--loss_adv_type", type=str, default="chamfer",
                        choices=["latent", "chamfer"])
    parser.add_argument("--dist_weight_list", nargs="+", default=[1.0])
    parser.add_argument("--max_point_pert_weight", type=float, default=0.0)
    parser.add_argument("--max_point_dist_weight", type=float, default=0.0)
    parser.add_argument("--num_iterations", type=int, default=500)
    parser.add_argument("--num_iterations_thresh", type=int, default=400)
    parser.add_argument(
        "--batch_size", type=int, default=0,
        help="pairs per attack call; 0 = sized from the point count, "
        "at most the largest class's pair grid",
    )
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--restore_epoch", type=int, default=None)
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument(
        "--target_pc_idx_type", type=str, default="chamfer_nn_complete",
        choices=["latent_nn", "chamfer_nn_complete"],
    )
    parser.add_argument("--num_pc_for_attack", type=int, default=25)
    parser.add_argument("--num_pc_for_target", type=int, default=5)
    parser.add_argument("--correct_pred_only", type=int, default=0)
    parser.add_argument("--output_folder_name", type=str, default="attack_res")
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--use_mesh", type=int, default=1)
    parser.add_argument("--matmul_precision", type=str, default=None)
    parser.add_argument(
        "--chamfer_impl", type=str, default="auto",
        choices=["auto", "fused", "composed"],
        help="the chamfer route: the fused loss (K5) or composed (K1 + K3); "
        "'auto' measures both once on the card and takes the faster",
    )
    parser.add_argument(
        "--chamfer_refresh", type=int, default=0,
        help="frozen-assignment mode: recompute both attack chamfers' "
        "nearest-neighbour assignments every N iterations and hold them "
        "frozen in between (PARITY.md #13); 0 = exact every iteration",
    )
    parser.add_argument(
        "--encoder_vjp", type=str, default="auto",
        choices=["auto", "sparse", "dense"],
        help="the victim encoder's input gradient: 'sparse' runs its "
        "backward on the max-pool argmax rows only (first-argmax ties), "
        "'dense' is autograd (even tie split); 'auto' is dense",
    )
    parser.add_argument(
        "--trace_dir", type=str, default=None,
        help="write a torch.profiler trace of the first class's attack "
        "into this directory (open with ui.perfetto.dev)",
    )
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Run attack flags:", flags)
    device = resolve_device(flags.device, flags.matmul_precision)
    if flags.num_iterations_thresh > flags.num_iterations:
        raise ValueError("--num_iterations_thresh exceeds --num_iterations")
    if flags.chamfer_refresh < 0:
        raise ValueError("--chamfer_refresh must be >= 0")

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder,
        attack_pc_idx=flags.attack_pc_idx,
        num_pc_for_attack=flags.num_pc_for_attack,
    )
    conf = ctx.conf
    # attack-config mutation (reference: run_attack.py:83-109); BN stays
    # frozen by construction (eval mode) — the b_norm_decay=1.0 analog.
    conf.ae_dir = ctx.ae_dir
    conf.ae_name = "autoencoder"
    conf.ae_restore_epoch = flags.restore_epoch
    conf.experiment_name = "adversary"
    conf.learning_rate = flags.learning_rate
    conf.loss_dist_type = flags.loss_dist_type
    conf.loss_adv_type = flags.loss_adv_type
    conf.dist_weight_list = [float(w) for w in flags.dist_weight_list]
    conf.max_point_pert_weight = flags.max_point_pert_weight
    conf.max_point_dist_weight = flags.max_point_dist_weight
    conf.target_pc_idx_type = flags.target_pc_idx_type
    conf.num_pc_for_attack = flags.num_pc_for_attack
    conf.num_pc_for_target = flags.num_pc_for_target
    conf.correct_pred_only = bool(flags.correct_pred_only)
    conf.num_iterations = flags.num_iterations
    conf.num_iterations_thresh = flags.num_iterations_thresh
    conf.chamfer_refresh = flags.chamfer_refresh

    primary = is_primary()
    output_path = osp.join(ctx.data_path, flags.output_folder_name)
    conf.train_dir = output_path
    if primary:
        ensure_dir(output_path)
        conf.save(osp.join(output_path, "attack_configuration"))

    # the flags may change what the (pre-mutation) AE config resolved
    ctx.conf = conf
    ctx.nn_idx = load_data(
        ctx.data_path, ctx.files, [NN_IDX_DICT[conf.target_pc_idx_type]]
    )
    if conf.correct_pred_only and ctx.correct_pred is None:
        ctx.load_correct_pred()

    # pairs per attack call: the flag, else sized from the point count and
    # capped by the largest class's pair grid, so that the runner's
    # calibration measures the batch the attack sends
    batch_size = flags.batch_size or _auto_dispatch_batch(
        conf.n_input[0],
        max((ctx.class_attack_data(name, ctx.ae_loss)[1].size
             for _, name in ctx.classes_iter()), default=1),
    )
    # one process: a mesh of size 1, which the trainer and the runner treat
    # as none
    mesh = get_mesh() if flags.use_mesh else None
    victim = restore_victim(conf, ctx.ae_dir, device, flags.restore_epoch, mesh=mesh)
    runner = AttackRunner(victim.model, conf, device,
                          chamfer_impl=flags.chamfer_impl, batch_size=batch_size,
                          encoder_vjp=flags.encoder_vjp, mesh=mesh)
    processes = 1 if runner.mesh is None else runner.mesh.size
    print(f"attack routing: {runner.attack_mode}, encoder VJP "
          f"{runner.encoder_vjp}, {processes} process(es)")
    if primary:
        with open(osp.join(output_path, "attack_impl.json"), "w") as f:
            json.dump(
                {
                    "chamfer_impl_flag": flags.chamfer_impl,
                    "chamfer_method": runner.chamfer_method,
                    "chamfer_refresh": runner.chamfer_refresh,
                    "attack_mode": runner.attack_mode,
                    "encoder_vjp": flags.encoder_vjp,
                    "encoder_vjp_path": runner.encoder_vjp,
                    "batch_size": batch_size,
                    "calibration_seconds": runner.calibration_seconds,
                    "matmul_precision": flags.matmul_precision,
                    "device": str(device),
                    "processes": processes,
                },
                f,
                indent=1,
            )

    for i, pc_class_name in ctx.classes_iter():
        print(f"attack shape class {pc_class_name} "
              f"({i + 1} of {len(ctx.pc_classes)})")
        save_dir = osp.join(output_path, pc_class_name)

        source_pc, target_pc = ctx.class_attack_data(
            pc_class_name, ctx.point_clouds
        )
        _, target_latent = ctx.class_attack_data(
            pc_class_name, ctx.latent_vectors
        )
        _, target_ae_loss_ref = ctx.class_attack_data(
            pc_class_name, ctx.ae_loss
        )
        target_ae_loss_ref = target_ae_loss_ref.reshape(-1)

        trace_cm = contextlib.nullcontext()
        if flags.trace_dir is not None and i == 0 and primary:
            print(f"tracing this class's attack into {flags.trace_dir}")
            trace_cm = trace(flags.trace_dir, device)
        log_cm = contextlib.nullcontext()
        if primary:
            log_cm = open(osp.join(ensure_dir(save_dir), "attack_stats.txt"), "a", 1)
        with log_cm as fout:
            if fout is not None:
                fout.write(f"Attack flags: {flags}\n")
            with trace_cm:
                out = runner.attack(
                    source_pc, target_latent, target_pc, target_ae_loss_ref,
                    log_file=fout,
                )

        if primary:
            np.save(osp.join(save_dir, "adversarial_metrics"), out.metrics)
            np.save(osp.join(save_dir, "adversarial_pc_input"), out.pc_input)
            np.save(osp.join(save_dir, "adversarial_pc_recon"), out.pc_recon)
            np.save(
                osp.join(save_dir, "dist_weight"),
                np.array(conf.dist_weight_list),
            )
    barrier()  # the primary's artifacts are on disk for every rank


if __name__ == "__main__":
    main()
