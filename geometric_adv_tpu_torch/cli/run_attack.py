"""Run the geometric adversarial attack (``geometric_adv_tpu/cli/run_attack.py``;
reference: attacker/run_attack.py).

Per source class: assemble the source/target pair grid, run the attack over
all dist weights, save the per-class artifacts (adversarial_metrics /
_pc_input / _pc_recon / dist_weight). The victim's ``conf.loss`` (chamfer or
EMD) selects the attack's losses. Flags keep the JAX stage's names; a value
that selects work the port does not have yet raises."""

import argparse
import json
import os.path as osp

import numpy as np
import torch

from geometric_adv_tpu_torch.attack.core import AttackRunner
from geometric_adv_tpu_torch.cli.common import (
    NN_IDX_DICT,
    AttackContext,
    add_device_flag,
    ensure_dir,
    resolve_device,
    restore_victim,
)
from geometric_adv_tpu_torch.utils.artifacts import load_data


def _reject_unported(flags, device) -> None:
    unported = {
        "--chamfer_impl fused (kernel K5, ROADMAP Queue 2)":
            flags.chamfer_impl == "fused",
        "--chamfer_refresh > 0 (ROADMAP Queue 1 item 9)":
            flags.chamfer_refresh > 0,
        "--encoder_vjp sparse (ROADMAP Queue 1 item 16)":
            flags.encoder_vjp == "sparse",
        "--trace_dir (device traces)": flags.trace_dir is not None,
        "--use_mesh 1 on more than one device (ROADMAP Queue 1 item 17)":
            bool(flags.use_mesh) and device.type == "cuda"
            and torch.cuda.device_count() > 1,
    }
    chosen = [name for name, hit in unported.items() if hit]
    if chosen:
        raise NotImplementedError("not ported yet: " + "; ".join(chosen))


def main(argv=None):
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
        help="pairs per attack call; 0 = sized from the point count",
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
    parser.add_argument("--chamfer_impl", type=str, default="auto",
                        choices=["auto", "fused", "composed"])
    parser.add_argument("--chamfer_refresh", type=int, default=0)
    parser.add_argument("--encoder_vjp", type=str, default="auto",
                        choices=["auto", "sparse", "dense"])
    parser.add_argument("--trace_dir", type=str, default=None)
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Run attack flags:", flags)
    device = resolve_device(flags.device, flags.matmul_precision)
    _reject_unported(flags, device)
    if flags.num_iterations_thresh > flags.num_iterations:
        raise ValueError("--num_iterations_thresh exceeds --num_iterations")

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

    output_path = ensure_dir(osp.join(ctx.data_path, flags.output_folder_name))
    conf.train_dir = output_path
    conf.save(osp.join(output_path, "attack_configuration"))

    # the flags may change what the (pre-mutation) AE config resolved
    ctx.conf = conf
    ctx.nn_idx = load_data(
        ctx.data_path, ctx.files, [NN_IDX_DICT[conf.target_pc_idx_type]]
    )
    if conf.correct_pred_only and ctx.correct_pred is None:
        ctx.load_correct_pred()

    victim = restore_victim(conf, ctx.ae_dir, device, flags.restore_epoch)
    runner = AttackRunner(victim.model, conf, device)
    with open(osp.join(output_path, "attack_impl.json"), "w") as f:
        json.dump(
            {
                "chamfer_impl_flag": flags.chamfer_impl,
                "chamfer_method": "composed",
                "chamfer_refresh": 0,
                "attack_mode": "composed",
                "encoder_vjp": "dense",
                "device": str(device),
            },
            f,
            indent=1,
        )

    for i, pc_class_name in ctx.classes_iter():
        print(f"attack shape class {pc_class_name} "
              f"({i + 1} of {len(ctx.pc_classes)})")
        save_dir = ensure_dir(osp.join(output_path, pc_class_name))

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

        with open(osp.join(save_dir, "attack_stats.txt"), "a", 1) as fout:
            fout.write(f"Attack flags: {flags}\n")
            out = runner.attack(
                source_pc, target_latent, target_pc, target_ae_loss_ref,
                batch_size=flags.batch_size or None, log_file=fout,
            )

        np.save(osp.join(save_dir, "adversarial_metrics"), out.metrics)
        np.save(osp.join(save_dir, "adversarial_pc_input"), out.pc_input)
        np.save(osp.join(save_dir, "adversarial_pc_recon"), out.pc_recon)
        np.save(
            osp.join(save_dir, "dist_weight"),
            np.array(conf.dist_weight_list),
        )


if __name__ == "__main__":
    main()
