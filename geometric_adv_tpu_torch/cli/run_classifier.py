"""Classify reconstructions per data_type
(``geometric_adv_tpu/cli/run_classifier.py``; reference:
classifier/run_classifier.py): {target, adversarial, source, before_defense,
after_defense} -> per-class ``*_pc_recon_pred.npy``."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.attack.pipeline import get_quantity_at_index
from geometric_adv_tpu_torch.classify import ClassifierTrainer
from geometric_adv_tpu_torch.cli.common import (
    AttackContext,
    add_device_flag,
    ensure_dir,
    resolve_device,
)
from geometric_adv_tpu_torch.train.config import Configuration

DATA_TYPES = (
    "target", "adversarial", "source", "before_defense", "after_defense"
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_type", type=str, default="adversarial")
    parser.add_argument("--classifier_folder", type=str, default="log/pointnet")
    parser.add_argument("--classifier_restore_epoch", type=int, default=None)
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--attack_folder", type=str, default="attack_res")
    parser.add_argument(
        "--defense_folder", type=str, default="defense_critical_res"
    )
    parser.add_argument("--output_folder_name", type=str, default="classifier_res")
    parser.add_argument("--project_dir", type=str, default=".")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Run classifier flags:", flags)
    if flags.data_type not in DATA_TYPES:
        raise ValueError(
            f"wrong data_type: {flags.data_type!r} (choose from {DATA_TYPES})")
    device = resolve_device(flags.device)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )

    # output routing (reference: run_classifier.py:51-66)
    if flags.data_type in ("target", "adversarial"):
        cls_data_path = ctx.attack_dir
        suffix = "_orig" if flags.data_type == "target" else ""
        output_path = ensure_dir(
            osp.join(cls_data_path, flags.output_folder_name + suffix)
        )
    elif flags.data_type == "source":
        cls_data_path = osp.join(ctx.attack_dir, flags.defense_folder)
        output_path = ensure_dir(
            osp.join(cls_data_path, flags.output_folder_name + "_orig")
        )
    elif flags.data_type == "before_defense":
        cls_data_path = ctx.attack_dir
        output_path = ensure_dir(
            osp.join(ctx.attack_dir, flags.defense_folder,
                     flags.output_folder_name)
        )
    else:  # after_defense
        cls_data_path = osp.join(ctx.attack_dir, flags.defense_folder)
        output_path = ensure_dir(
            osp.join(cls_data_path, flags.output_folder_name)
        )

    ae_conf = Configuration.load(osp.join(ctx.ae_dir, "configuration"))
    classifier = ClassifierTrainer(num_classes=len(ae_conf.class_names), device=device)
    classifier.restore(
        osp.join(flags.project_dir, flags.classifier_folder),
        flags.classifier_restore_epoch,
    )

    for i, pc_class_name in ctx.classes_iter():
        save_dir = ensure_dir(osp.join(output_path, pc_class_name))
        print(f"Classify shape class {pc_class_name} ({flags.data_type})")

        source_recon_ref, target_recon_ref = ctx.class_attack_data(
            pc_class_name, ctx.reconstructions
        )

        load_dir = osp.join(cls_data_path, pc_class_name)
        if flags.data_type == "target":
            pc_recon = np.expand_dims(target_recon_ref, 0)
        elif flags.data_type in ("adversarial", "before_defense"):
            adv_recon = np.load(
                osp.join(ctx.attack_dir, pc_class_name,
                         "adversarial_pc_recon.npy")
            )
            norm_min_idx = np.load(
                osp.join(ctx.attack_dir, pc_class_name, "analysis_results",
                         "source_target_norm_min_idx.npy")
            )
            pc_recon = np.expand_dims(
                get_quantity_at_index([adv_recon], norm_min_idx), 0
            )
        elif flags.data_type == "source":
            pc_recon = np.expand_dims(source_recon_ref, 0)
        else:  # after_defense
            pc_recon = np.load(osp.join(load_dir, "defended_pc_recon.npy"))

        num_w, num_pc = pc_recon.shape[:2]
        pred = np.zeros([num_w, num_pc], np.int8)
        for j in range(num_w):
            pred[j] = classifier.classify(pc_recon[j])

        out_name = {
            "target": "target_pc_recon_pred",
            "adversarial": "adversarial_pc_recon_pred",
            "before_defense": "adversarial_pc_recon_pred",
            "source": "source_pc_recon_pred",
            "after_defense": "defended_pc_recon_pred",
        }[flags.data_type]
        np.save(osp.join(save_dir, out_name), pred)


if __name__ == "__main__":
    main()
