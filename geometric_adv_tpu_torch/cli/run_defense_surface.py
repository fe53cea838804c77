"""Off-surface defense (``geometric_adv_tpu/cli/run_defense_surface.py``;
reference: defender/run_defense_surface.py).

Removes points whose mean distance to their num_knn_for_defense nearest
neighbors exceeds knn_dist_thresh (from ``get_knn_dists_per_point``'s
artifacts), re-encodes on ``--device`` (default cuda), records
defense_metrics."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.attack.pipeline import get_quantity_at_index
from geometric_adv_tpu_torch.cli.common import (
    AttackContext,
    add_device_flag,
    ensure_dir,
    resolve_device,
    restore_victim,
)
from geometric_adv_tpu_torch.defense import get_outlier_pc_inlier_pc


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--attack_folder", type=str, default="attack_res")
    parser.add_argument("--num_knn_for_defense", type=int, default=2)
    parser.add_argument("--knn_dist_thresh", type=float, default=0.04)
    parser.add_argument("--restore_epoch", type=int, default=None)
    parser.add_argument(
        "--output_folder_name", type=str, default="defense_surface_res"
    )
    parser.add_argument("--project_dir", type=str, default=".")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Run defense surface flags:", flags)
    device = resolve_device(flags.device)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )
    conf = ctx.conf
    conf.defense_type = "surface"
    conf.num_knn = flags.num_knn_for_defense
    conf.knn_dist_thresh = flags.knn_dist_thresh
    output_path = ensure_dir(osp.join(ctx.attack_dir, flags.output_folder_name))
    output_path_orig = ensure_dir(
        osp.join(ctx.attack_dir, flags.output_folder_name + "_orig")
    )
    conf.train_dir = output_path
    conf.save(osp.join(output_path, "defense_configuration"))
    conf.save(osp.join(output_path_orig, "defense_configuration"))

    victim = restore_victim(conf, ctx.ae_dir, device, flags.restore_epoch)

    def defend(pc_input, knn_dists, source_pc, source_loss_ref):
        knn_mean = np.mean(
            knn_dists[:, :, : flags.num_knn_for_defense], axis=-1
        )
        out_pc, out_idx, out_num, defended = get_outlier_pc_inlier_pc(
            pc_input, knn_mean, flags.knn_dist_thresh
        )
        def_recon = victim.get_reconstructions(defended)
        def_sre = victim.get_loss_per_pc(defended, source_pc)
        return out_pc, out_idx, out_num, defended, def_recon, def_sre

    for i, pc_class_name in ctx.classes_iter():
        print(f"defend shape class {pc_class_name}")
        save_dir = ensure_dir(osp.join(output_path, pc_class_name))
        save_dir_orig = ensure_dir(osp.join(output_path_orig, pc_class_name))

        source_pc, _ = ctx.class_attack_data(pc_class_name, ctx.point_clouds)
        source_loss_ref, _ = ctx.class_attack_data(pc_class_name, ctx.ae_loss)
        source_loss_ref = source_loss_ref.reshape(-1)

        load_dir = osp.join(ctx.attack_dir, pc_class_name)
        adv_input = np.load(osp.join(load_dir, "adversarial_pc_input.npy"))
        norm_min_idx = np.load(
            osp.join(load_dir, "analysis_results",
                     "source_target_norm_min_idx.npy")
        )
        adv_input = np.expand_dims(
            get_quantity_at_index([adv_input], norm_min_idx), 0
        )
        knn_all = np.load(
            osp.join(save_dir, "knn_dists_adversarial_pc_input.npy")
        )

        num_w, num_pc, num_points = adv_input.shape[:3]
        out_points = np.zeros([num_w, num_pc, num_points, 3], adv_input.dtype)
        out_idx_all = np.zeros([num_w, num_pc, num_points], np.int16)
        out_num_all = np.zeros([num_w, num_pc], np.int16)
        defended_in = np.zeros_like(adv_input)
        defended_rec = np.zeros_like(adv_input)
        metrics = np.zeros([num_w, num_pc, 4], np.float32)

        for j in range(num_w):
            op, oi, on, defended, def_recon, def_sre = defend(
                adv_input[j], knn_all[j], source_pc, source_loss_ref
            )
            adv_sre = victim.get_loss_per_pc(adv_input[j], source_pc)
            out_points[j], out_idx_all[j], out_num_all[j] = op, oi, on
            defended_in[j], defended_rec[j] = defended, def_recon
            metrics[j] = np.stack(
                [def_sre, def_sre / source_loss_ref, adv_sre,
                 adv_sre / source_loss_ref], axis=-1,
            )

        # trim to max outlier count (reference :228-231)
        out_max = max(int(out_num_all.max()), 1)
        np.save(
            osp.join(save_dir, "adversarial_critical_points"),
            out_points[:, :, :out_max],
        )
        np.save(
            osp.join(save_dir, "adversarial_critical_idx"),
            out_idx_all[:, :, :out_max],
        )
        np.save(osp.join(save_dir, "adversarial_critical_num"), out_num_all)
        np.save(osp.join(save_dir, "defended_pc_input"), defended_in)
        np.save(osp.join(save_dir, "defended_pc_recon"), defended_rec)
        np.save(osp.join(save_dir, "defense_metrics"), metrics)

        # _orig control on clean sources
        knn_src = np.load(osp.join(save_dir_orig, "knn_dists_source_pc.npy"))
        s_op, s_oi, s_on, s_def, s_def_recon, s_def_sre = defend(
            source_pc, knn_src, source_pc, source_loss_ref
        )
        s_metrics = np.stack(
            [s_def_sre, s_def_sre / source_loss_ref, source_loss_ref,
             np.ones_like(source_loss_ref)], axis=-1,
        )
        np.save(osp.join(save_dir_orig, "original_source_critical_points"), s_op)
        np.save(osp.join(save_dir_orig, "original_critical_idx"), s_oi)
        np.save(osp.join(save_dir_orig, "original_critical_num"), s_on)
        np.save(osp.join(save_dir_orig, "defended_source_input"), s_def)
        np.save(osp.join(save_dir_orig, "defended_source_recon"), s_def_recon)
        np.save(osp.join(save_dir_orig, "defense_source_metrics"), s_metrics)
        print(
            f"  outliers {out_num_all.mean():.1f}/pc, def S-RE "
            f"{metrics[0, :, 0].mean():.5f} vs adv {metrics[0, :, 2].mean():.5f}"
        )


if __name__ == "__main__":
    main()
