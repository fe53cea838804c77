"""Defense statistics (``geometric_adv_tpu/cli/evaluate_defense.py``;
reference: defender/evaluate_defense.py). Host only.

Selects defense metrics at the attack's targeted/untargeted best indices and
writes over_classes/eval_stats.txt with
[Def S-RE, Def S-NRE, Adv S-RE, Adv S-NRE]."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.attack.pipeline import (
    get_quantity_for_targeted_untargeted_attack,
)
from geometric_adv_tpu_torch.cli.common import AttackContext, ensure_dir
from geometric_adv_tpu_torch.utils.stats import write_defense_statistics_to_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--attack_folder", type=str, default="attack_res")
    parser.add_argument(
        "--defense_folder", type=str, default="defense_critical_res"
    )
    parser.add_argument(
        "--use_adversarial_data", type=int, default=1,
        help="0: evaluate the defense on clean sources (the _orig control)",
    )
    parser.add_argument("--project_dir", type=str, default=".")
    flags = parser.parse_args(argv)
    print("Evaluate defense flags:", flags)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )
    defense_path = osp.join(
        ctx.attack_dir,
        flags.defense_folder + ("" if flags.use_adversarial_data else "_orig"),
    )

    agg = {k: [] for k in ("def_sre", "def_snre", "adv_sre", "adv_snre")}
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
        load_dir_defense = osp.join(defense_path, pc_class_name)
        if flags.use_adversarial_data:
            metrics = np.load(
                osp.join(load_dir_defense, "defense_metrics.npy")
            )
        else:
            src_metrics = np.load(
                osp.join(load_dir_defense, "defense_source_metrics.npy")
            )
            metrics = np.expand_dims(src_metrics, 0)

        # metrics were saved at the best dist weight already -> selection
        # index is all-zeros over the single weight axis
        zero_idx = np.zeros(metrics.shape[1], np.int16)
        names = ["def_sre", "def_snre", "adv_sre", "adv_snre"]
        for k, name in enumerate(names):
            q = metrics[:, :, k]
            if flags.use_adversarial_data:
                _, targeted, _ = get_quantity_for_targeted_untargeted_attack(
                    q, zero_idx, per_tc_idx, all_idx
                )
                agg[name].append(targeted)
            else:
                # clean-source control: one value per source instance
                agg[name].append(q[0].reshape(-1, 1))
        class_names.append(pc_class_name)

    over_dir = ensure_dir(osp.join(defense_path, "over_classes"))
    with open(osp.join(over_dir, "eval_stats.txt"), "w", 1) as fout:
        write_defense_statistics_to_file(
            fout, class_names, agg["def_sre"], agg["def_snre"],
            agg["adv_sre"], agg["adv_snre"],
        )
    print("wrote", osp.join(over_dir, "eval_stats.txt"))


if __name__ == "__main__":
    main()
