"""Transferability statistics (``geometric_adv_tpu/cli/evaluate_transfer.py``;
reference: transfer/evaluate_transfer.py).

Selects the transfer metrics at the attack's targeted indices and writes
over_classes/eval_stats.txt with [Tra T-RE, Tra T-NRE, Adv T-RE, Adv T-NRE].
The statistics run on the host; ``--device`` is checked like every stage's.
"""

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
from geometric_adv_tpu_torch.utils.stats import write_transfer_statistics_to_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--transfer_ae_type", type=str, default="AtlasNet")
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--attack_folder", type=str, default="attack_res")
    parser.add_argument("--output_folder_name", type=str, default="transfer_res")
    parser.add_argument("--project_dir", type=str, default=".")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Evaluate transfer flags:", flags)
    resolve_device(flags.device)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )
    transfer_path = osp.join(
        ctx.attack_dir,
        flags.output_folder_name + "_" + flags.transfer_ae_type.lower(),
    )

    agg = {k: [] for k in ("tra_tre", "tra_tnre", "adv_tre", "adv_tnre")}
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
        metrics = np.load(
            osp.join(transfer_path, pc_class_name, "transfer_metrics.npy")
        )
        zero_idx = np.zeros(metrics.shape[1], np.int16)
        for k, name in enumerate(("tra_tre", "tra_tnre", "adv_tre",
                                  "adv_tnre")):
            _, targeted, _ = get_quantity_for_targeted_untargeted_attack(
                metrics[:, :, k], zero_idx, per_tc_idx, all_idx
            )
            agg[name].append(targeted)
        class_names.append(pc_class_name)

    over_dir = ensure_dir(osp.join(transfer_path, "over_classes"))
    with open(osp.join(over_dir, "eval_stats.txt"), "w", 1) as fout:
        write_transfer_statistics_to_file(
            fout, class_names, agg["tra_tre"], agg["tra_tnre"],
            agg["adv_tre"], agg["adv_tnre"],
        )
    print("wrote", osp.join(over_dir, "eval_stats.txt"))
    print(
        f"over classes: tra T-RE {np.vstack(agg['tra_tre']).mean():.5f} "
        f"vs adv T-RE {np.vstack(agg['adv_tre']).mean():.5f}"
    )


if __name__ == "__main__":
    main()
