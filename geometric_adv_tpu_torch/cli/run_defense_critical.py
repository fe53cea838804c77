"""Critical-points defense (``geometric_adv_tpu/cli/run_defense_critical.py``;
reference: defender/run_defense_critical.py).

Per class: select the best-dist-weight adversarial inputs, remove their
critical points, re-encode the remainder, and record
defense_metrics = [def S-RE, def S-NRE, adv S-RE, adv S-NRE]. Also runs the
defense on the clean sources (the _orig control run). The victim runs on
``--device`` (default cuda); the critical points are chosen on the host
from the per-channel argmax reduced on the device."""

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
from geometric_adv_tpu_torch.defense import get_critical_pc_non_critical_pc


def defend_batch(victim, pc_input, source_pc, source_loss_ref,
                 sanity_checks=False):
    max_idx, max_val = victim.get_pre_symmetry_argmax(pc_input)
    crit_pts, crit_idx, crit_num, critical_pc, defended = \
        get_critical_pc_non_critical_pc(
            pc_input, max_idx_all=max_idx, max_val_all=max_val
        )
    if sanity_checks:
        # pooling invariance: reconstructing only the critical points must
        # equal reconstructing the full cloud
        # (reference: run_defense_critical.py:189-192)
        full_recon = victim.get_reconstructions(pc_input)
        crit_recon = victim.get_reconstructions(critical_pc)
        diff = np.abs(full_recon - crit_recon).max()
        if not diff < 1e-5:
            raise RuntimeError(
                f"critical-points pooling invariance violated: {diff:.2e}")
    def_recon = victim.get_reconstructions(defended)
    def_sre = victim.get_loss_per_pc(defended, source_pc)
    def_snre = def_sre / source_loss_ref
    return crit_pts, crit_idx, crit_num, defended, def_recon, def_sre, def_snre


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--attack_folder", type=str, default="attack_res")
    parser.add_argument("--restore_epoch", type=int, default=None)
    parser.add_argument(
        "--output_folder_name", type=str, default="defense_critical_res"
    )
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--do_sanity_checks", type=int, default=0)
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Run defense critical flags:", flags)
    device = resolve_device(flags.device)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )
    conf = ctx.conf
    conf.defense_type = "critical"
    output_path = ensure_dir(osp.join(ctx.attack_dir, flags.output_folder_name))
    output_path_orig = ensure_dir(
        osp.join(ctx.attack_dir, flags.output_folder_name + "_orig")
    )
    conf.train_dir = output_path
    conf.save(osp.join(output_path, "defense_configuration"))
    conf.save(osp.join(output_path_orig, "defense_configuration"))

    victim = restore_victim(conf, ctx.ae_dir, device, flags.restore_epoch)

    for i, pc_class_name in ctx.classes_iter():
        print(f"defend shape class {pc_class_name}")
        save_dir = ensure_dir(osp.join(output_path, pc_class_name))
        save_dir_orig = ensure_dir(osp.join(output_path_orig, pc_class_name))

        source_pc, _ = ctx.class_attack_data(pc_class_name, ctx.point_clouds)
        source_loss_ref, _ = ctx.class_attack_data(pc_class_name, ctx.ae_loss)
        source_loss_ref = source_loss_ref.reshape(-1)

        if flags.do_sanity_checks:
            # replay parity bars (reference: run_defense_critical.py:117-127)
            source_recon_ref, _ = ctx.class_attack_data(
                pc_class_name, ctx.reconstructions
            )
            source_recon = victim.get_reconstructions(source_pc)
            diff_recon = np.abs(source_recon - source_recon_ref).max()
            if not diff_recon < 1e-6:
                raise RuntimeError(
                    f"source recon replay drift {diff_recon:.2e} >= 1e-6")
            source_loss = victim.get_loss_per_pc(source_pc)
            diff_loss = np.abs(source_loss - source_loss_ref).max()
            if not diff_loss < 1e-7:
                raise RuntimeError(
                    f"source loss replay drift {diff_loss:.2e} >= 1e-7")

        load_dir = osp.join(ctx.attack_dir, pc_class_name)
        adv_input = np.load(osp.join(load_dir, "adversarial_pc_input.npy"))
        norm_min_idx = np.load(
            osp.join(load_dir, "analysis_results",
                     "source_target_norm_min_idx.npy")
        )
        adv_input = np.expand_dims(
            get_quantity_at_index([adv_input], norm_min_idx), 0
        )
        num_w, num_pc = adv_input.shape[:2]
        bneck = ctx.latent_vectors.shape[1]

        crit_points = np.zeros([num_w, num_pc, bneck, 3], adv_input.dtype)
        crit_idx_all = np.zeros([num_w, num_pc, bneck], np.int16)
        crit_num_all = np.zeros([num_w, num_pc], np.int16)
        defended_in = np.zeros_like(adv_input)
        defended_rec = np.zeros_like(adv_input)
        metrics = np.zeros([num_w, num_pc, 4], np.float32)

        for j in range(num_w):
            (cp, ci, cn, defended, def_recon, def_sre, def_snre) = \
                defend_batch(victim, adv_input[j], source_pc, source_loss_ref,
                             sanity_checks=bool(flags.do_sanity_checks))
            adv_sre = victim.get_loss_per_pc(adv_input[j], source_pc)
            adv_snre = adv_sre / source_loss_ref
            crit_points[j, :, :cp.shape[1]] = cp[:, :bneck]
            crit_idx_all[j, :, :ci.shape[1]] = ci[:, :bneck]
            crit_num_all[j] = cn
            defended_in[j] = defended
            defended_rec[j] = def_recon
            metrics[j] = np.stack(
                [def_sre, def_snre, adv_sre, adv_snre], axis=-1
            )

        np.save(osp.join(save_dir, "adversarial_critical_points"), crit_points)
        np.save(osp.join(save_dir, "adversarial_critical_idx"), crit_idx_all)
        np.save(osp.join(save_dir, "adversarial_critical_num"), crit_num_all)
        np.save(osp.join(save_dir, "defended_pc_input"), defended_in)
        np.save(osp.join(save_dir, "defended_pc_recon"), defended_rec)
        np.save(osp.join(save_dir, "defense_metrics"), metrics)

        # _orig control: defense on the clean sources (reference :230-263)
        (s_cp, s_ci, s_cn, s_def, s_def_recon, s_def_sre, s_def_snre) = \
            defend_batch(victim, source_pc, source_pc, source_loss_ref)
        s_metrics = np.stack(
            [s_def_sre, s_def_snre, source_loss_ref,
             np.ones_like(source_loss_ref)], axis=-1,
        )
        np.save(osp.join(save_dir_orig, "original_source_critical_points"), s_cp)
        np.save(osp.join(save_dir_orig, "original_critical_idx"), s_ci)
        np.save(osp.join(save_dir_orig, "original_critical_num"), s_cn)
        np.save(osp.join(save_dir_orig, "defended_source_input"), s_def)
        np.save(osp.join(save_dir_orig, "defended_source_recon"), s_def_recon)
        np.save(osp.join(save_dir_orig, "defense_source_metrics"), s_metrics)
        print(
            f"  def S-RE {metrics[0, :, 0].mean():.5f} vs adv S-RE "
            f"{metrics[0, :, 2].mean():.5f}"
        )


if __name__ == "__main__":
    main()
