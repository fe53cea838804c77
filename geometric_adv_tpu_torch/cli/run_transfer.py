"""Run adversarial inputs through a transfer AE
(``geometric_adv_tpu/cli/run_transfer.py``; reference:
transfer/run_transfer.py): reconstruct the best-dist-weight adversarial
inputs with an independently trained AE and record transfer_metrics =
[tra T-RE, tra T-NRE, adv T-RE, adv T-NRE].

``--do_sanity_checks 1`` with the victim as its own transfer AE replays the
attack's reconstructions and T-RE within 1e-6 (the port computes in full
float32, the JAX package's ``--matmul_precision float32`` case)."""

import argparse
import os.path as osp

import numpy as np
import torch

from geometric_adv_tpu_torch.attack.pipeline import get_quantity_at_index
from geometric_adv_tpu_torch.cli.common import (
    AttackContext,
    add_device_flag,
    ensure_dir,
    resolve_device,
    restore_victim,
)
from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.transfer import get_transfer_ae, load_transfer_arch

REPLAY_TOL = 1e-6


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--transfer_ae_type", type=str, default="AtlasNet",
        choices=["PointNet", "AtlasNet", "FoldingNet"],
    )
    parser.add_argument("--transfer_ae_folder", type=str, required=True)
    parser.add_argument("--transfer_ae_restore_epoch", type=int, default=None)
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--attack_folder", type=str, default="attack_res")
    parser.add_argument("--output_folder_name", type=str, default="transfer_res")
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--do_sanity_checks", type=int, default=0)
    parser.add_argument("--matmul_precision", type=str, default=None)
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Run transfer flags:", flags)
    device = resolve_device(flags.device, flags.matmul_precision)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )
    transfer_dir = osp.join(flags.project_dir, flags.transfer_ae_folder)
    output_path = ensure_dir(
        osp.join(ctx.attack_dir,
                 flags.output_folder_name + "_" + flags.transfer_ae_type.lower())
    )

    if flags.transfer_ae_type == "PointNet":
        t_conf = Configuration.load(osp.join(transfer_dir, "configuration"))
        ae = restore_victim(t_conf, transfer_dir, device,
                            flags.transfer_ae_restore_epoch)
    else:
        arch = load_transfer_arch(transfer_dir) or {}
        arch.pop("ae_type", None)
        if arch:
            print(f"transfer arch from {transfer_dir}/arch.json: {arch}")
        ae = get_transfer_ae(flags.transfer_ae_type.lower(), device=device, **arch)
        ae.restore(transfer_dir, flags.transfer_ae_restore_epoch)

    for i, pc_class_name in ctx.classes_iter():
        print(f"transfer shape class {pc_class_name}")
        save_dir = ensure_dir(osp.join(output_path, pc_class_name))

        _, target_pc = ctx.class_attack_data(pc_class_name, ctx.point_clouds)
        _, target_loss_ref = ctx.class_attack_data(pc_class_name, ctx.ae_loss)
        target_loss_ref = target_loss_ref.reshape(-1)

        load_dir = osp.join(ctx.attack_dir, pc_class_name)
        adv_input = np.load(osp.join(load_dir, "adversarial_pc_input.npy"))
        adv_metrics = np.load(osp.join(load_dir, "adversarial_metrics.npy"))
        norm_min_idx = np.load(
            osp.join(load_dir, "analysis_results",
                     "source_target_norm_min_idx.npy")
        )
        adv_input, adv_metrics = get_quantity_at_index(
            [adv_input, adv_metrics], norm_min_idx
        )
        adv_input = np.expand_dims(adv_input, 0)
        adv_metrics = np.expand_dims(adv_metrics, 0)

        num_w, num_pc = adv_input.shape[:2]
        tra_recon = None
        tra_tre = np.zeros([num_w, num_pc], np.float32)
        for j in range(num_w):
            recon = ae.get_reconstructions(adv_input[j])
            if tra_recon is None:
                tra_recon = np.zeros((num_w,) + recon.shape, recon.dtype)
            tra_recon[j] = recon
            if flags.transfer_ae_type == "PointNet":
                tra_tre[j] = ae.get_loss_per_pc(adv_input[j], target_pc)
            else:
                with torch.no_grad():
                    tra_tre[j] = chamfer_loss_per_pc(
                        torch.as_tensor(recon, device=device),
                        torch.as_tensor(target_pc.astype(np.float32), device=device),
                    ).cpu().numpy()
        tra_tnre = tra_tre / target_loss_ref[None, :]

        if (
            flags.do_sanity_checks
            and flags.transfer_ae_type == "PointNet"
            and flags.transfer_ae_folder == flags.ae_folder
        ):
            # identity sanity: transfer AE == victim must reproduce the
            # attack's own reconstructions and errors
            # (reference: run_transfer.py:181-204)
            adv_recon = np.load(osp.join(load_dir, "adversarial_pc_recon.npy"))
            adv_recon = np.expand_dims(
                get_quantity_at_index([adv_recon], norm_min_idx), 0
            )
            diff_recon = float(np.abs(tra_recon - adv_recon).max())
            if not diff_recon < REPLAY_TOL:
                raise RuntimeError(
                    f"identity transfer recon drift {diff_recon:.2e} >= {REPLAY_TOL:g}")
            diff_tre = float(np.abs(tra_tre - adv_metrics[:, :, 4]).max())
            if not diff_tre < REPLAY_TOL:
                raise RuntimeError(
                    f"identity transfer T-RE drift {diff_tre:.2e} >= {REPLAY_TOL:g}")
            print(f"  identity sanity checks passed (recon drift {diff_recon:.3g}, "
                  f"T-RE drift {diff_tre:.3g})")

        transfer_metrics = np.stack(
            [tra_tre, tra_tnre, adv_metrics[:, :, 4], adv_metrics[:, :, 3]],
            axis=-1,
        )
        np.save(osp.join(save_dir, "transferred_pc_recon"), tra_recon)
        np.save(osp.join(save_dir, "transfer_metrics"), transfer_metrics)
        print(
            f"  tra T-RE {tra_tre.mean():.5f} vs adv T-RE "
            f"{adv_metrics[:, :, 4].mean():.5f}"
        )


if __name__ == "__main__":
    main()
