"""Semantic attack statistics (``geometric_adv_tpu/cli/evaluate_classifier.py``;
reference: classifier/evaluate_classifier.py).

Per data_type, compares the classifier's predictions on reconstructions with
the source/target labels: hit_target (pred == target label) or avoid_source
(pred != source label) for target/adversarial data, back to source (pred ==
source label) for source and defense data; selected at the attack's targeted
indices and written in the classification stats format. The statistics run
on the host; ``--device`` is checked like every stage's."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.attack.pipeline import (
    get_quantity_for_targeted_untargeted_attack,
)
from geometric_adv_tpu_torch.cli.common import (
    AttackContext,
    add_device_flag,
    ensure_dir,
    resolve_device,
)
from geometric_adv_tpu_torch.utils.artifacts import load_data
from geometric_adv_tpu_torch.utils.stats import (
    write_classification_statistics_to_file,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_type", type=str, default="adversarial")
    parser.add_argument(
        "--classification_type", type=str, default="hit_target",
        choices=["hit_target", "avoid_source"],
    )
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
    print("Evaluate classifier flags:", flags)
    resolve_device(flags.device)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )
    pc_labels = load_data(ctx.data_path, ctx.files, ["pc_label_test_set"])

    # prediction artifact location per data_type (reference :49-60)
    if flags.data_type == "target":
        pred_path = osp.join(ctx.attack_dir, flags.output_folder_name + "_orig")
        pred_file = "target_pc_recon_pred.npy"
    elif flags.data_type == "adversarial":
        pred_path = osp.join(ctx.attack_dir, flags.output_folder_name)
        pred_file = "adversarial_pc_recon_pred.npy"
    elif flags.data_type == "source":
        pred_path = osp.join(
            ctx.attack_dir, flags.defense_folder,
            flags.output_folder_name + "_orig",
        )
        pred_file = "source_pc_recon_pred.npy"
    elif flags.data_type == "before_defense":
        # predictions live in the adversarial classifier folder, but the
        # report belongs next to the after_defense one under the defense
        # folder (reference: evaluate_classifier.py:56-57)
        pred_path = osp.join(ctx.attack_dir, flags.output_folder_name)
        pred_file = "adversarial_pc_recon_pred.npy"
        stats_path = osp.join(
            ctx.attack_dir, flags.defense_folder, flags.output_folder_name
        )
    else:  # after_defense
        pred_path = osp.join(
            ctx.attack_dir, flags.defense_folder, flags.output_folder_name
        )
        pred_file = "defended_pc_recon_pred.npy"

    if flags.data_type != "before_defense":
        stats_path = pred_path
    agg = []
    class_names = []
    for i, pc_class_name in ctx.classes_iter():
        load_dir_attack = osp.join(ctx.attack_dir, pc_class_name)
        per_tc_idx = np.load(
            osp.join(load_dir_attack, "analysis_results",
                     "source_target_norm_min_per_target_class_idx.npy")
        )
        all_idx = np.load(
            osp.join(load_dir_attack, "analysis_results",
                     "source_target_norm_min_target_all_idx.npy")
        )
        src_labels, tgt_labels = ctx.class_attack_data(
            pc_class_name, np.asarray(pc_labels)
        )
        src_labels = src_labels.reshape(-1)
        tgt_labels = tgt_labels.reshape(-1)

        pred = np.load(osp.join(pred_path, pc_class_name, pred_file))

        if flags.data_type in ("target", "adversarial"):
            ref_labels = (
                tgt_labels
                if flags.classification_type == "hit_target"
                else src_labels
            )
            op = np.equal if flags.classification_type == "hit_target" else np.not_equal
            correct = op(pred, ref_labels[None, :])
        else:  # source, before/after defense: back to source
            correct = np.equal(pred, src_labels[None, :])

        correct = correct.astype(np.float32)
        zero_idx = np.zeros(correct.shape[1], np.int16)
        _, targeted, _ = get_quantity_for_targeted_untargeted_attack(
            correct, zero_idx, per_tc_idx, all_idx
        )
        agg.append(targeted)
        class_names.append(pc_class_name)

    over_dir = ensure_dir(osp.join(stats_path, "over_classes"))
    stats_name = f"eval_stats_{flags.data_type}_{flags.classification_type}.txt"
    with open(osp.join(over_dir, stats_name), "w", 1) as fout:
        write_classification_statistics_to_file(
            fout, class_names, agg, flags.data_type
        )
    print("wrote", osp.join(over_dir, stats_name))
    print(
        f"{flags.data_type}/{flags.classification_type} over classes: "
        f"{np.vstack(agg).mean():.4f}"
    )


if __name__ == "__main__":
    main()
