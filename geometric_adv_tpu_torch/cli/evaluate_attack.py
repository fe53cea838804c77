"""Attack analysis and statistics (``geometric_adv_tpu/cli/evaluate_attack.py``;
reference: attacker/evaluate_attack.py).

Per class: pick the best dist weight per attack by the minimal
``source_chamfer + target_recon_error`` norm, derive targeted (per target
class) and untargeted (best class) selections, count off-surface points
(dist > 0.05), save the analysis index artifacts every later stage consumes,
and write over_classes/eval_stats.txt + targeted/untargeted reports.
"""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.attack.pipeline import (
    get_quantity_for_targeted_untargeted_attack,
)
from geometric_adv_tpu_torch.cli.common import AttackContext, ensure_dir
from geometric_adv_tpu_torch.utils.stats import write_attack_statistics_to_file

OUTLIER_THRESH = 0.05  # reference: evaluate_attack.py:45


def analyse_class(ctx, pc_class_name):
    """The per-class block of reference: evaluate_attack.py:102-227."""
    conf = ctx.conf
    load_dir = osp.join(ctx.attack_dir, pc_class_name)
    adversarial_metrics = np.load(osp.join(load_dir, "adversarial_metrics.npy"))
    adversarial_pc_input_dists = np.load(
        osp.join(load_dir, "adversarial_pc_input_dists.npy")
    )
    save_dir = ensure_dir(osp.join(load_dir, "analysis_results"))

    num_instance = conf.num_pc_for_attack
    num_attacks = adversarial_metrics.shape[1]
    num_attack_per_instance = num_attacks // num_instance
    num_target_classes = num_attack_per_instance // conf.num_pc_for_target

    _, _, source_chamfer_dist, target_nre, target_recon_error = [
        np.squeeze(a, -1)
        for a in np.split(adversarial_metrics, 5, axis=-1)
    ]
    num_outlier = np.sum(
        adversarial_pc_input_dists > OUTLIER_THRESH, axis=-1
    ).astype(np.int16)

    # best dist weight per attack (reference :157-162)
    source_target_norm = source_chamfer_dist + target_recon_error
    norm_min_val = np.min(source_target_norm, axis=0)
    norm_min_idx = np.argmin(source_target_norm, axis=0)
    np.save(osp.join(save_dir, "source_target_norm_min_idx"), norm_min_idx)

    norm_min_reshape = norm_min_val.reshape(
        [num_instance, num_attack_per_instance]
    )

    # targeted: best candidate per (source, target class) (reference :167-176)
    per_tc_val = np.zeros([num_instance, num_target_classes], np.float32)
    per_tc_idx = np.zeros([num_instance, num_target_classes], np.int16)
    for k in range(num_target_classes):
        block = norm_min_reshape[
            :, k * conf.num_pc_for_target:(k + 1) * conf.num_pc_for_target
        ]
        per_tc_val[:, k] = np.min(block, axis=1)
        per_tc_idx[:, k] = np.argmin(block, axis=1)
    np.save(
        osp.join(save_dir, "source_target_norm_min_per_target_class_idx"),
        per_tc_idx,
    )

    # untargeted: best target class per source (reference :181-185)
    all_val = np.min(per_tc_val, axis=1)
    all_idx = np.argmin(per_tc_val, axis=1)
    np.save(osp.join(save_dir, "source_target_norm_min_target_all_idx"), all_idx)

    quantities = {}
    for name, q in [
        ("num_outlier", num_outlier),
        ("source_chamfer", source_chamfer_dist),
        ("target_chamfer", target_recon_error),
        ("target_nre", target_nre),
    ]:
        quantities[name] = get_quantity_for_targeted_untargeted_attack(
            q, norm_min_idx, per_tc_idx, all_idx
        )

    return {
        "norm_min_targeted": per_tc_val,
        "norm_min_untargeted": all_val,
        "quantities": quantities,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--output_folder_name", type=str, default="attack_res")
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--save_graphs", type=int, default=0)
    parser.add_argument("--save_pc_plots", type=int, default=0)
    flags = parser.parse_args(argv)
    print("Evaluate attack flags:", flags)
    if flags.save_graphs or flags.save_pc_plots:
        raise NotImplementedError(
            "--save_graphs / --save_pc_plots: the plots (matplotlib) are not "
            "ported yet"
        )

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder,
        attack_folder=flags.output_folder_name,
        attack_pc_idx=flags.attack_pc_idx,
    )

    over_dir = ensure_dir(osp.join(ctx.attack_dir, "over_classes"))
    agg_t = {k: [] for k in
             ("norm", "num_outlier", "source_chamfer", "target_chamfer",
              "target_nre")}
    agg_u = {k: [] for k in agg_t}
    class_names = []

    with open(osp.join(over_dir, "targeted_attacks.txt"), "w", 1) as ftar, \
            open(osp.join(over_dir, "untargeted_attacks.txt"), "w", 1) as funtar:
        for _, pc_class_name in ctx.classes_iter():
            print(f"evaluate shape class {pc_class_name}")
            res = analyse_class(ctx, pc_class_name)
            class_names.append(pc_class_name)
            agg_t["norm"].append(res["norm_min_targeted"])
            agg_u["norm"].append(res["norm_min_untargeted"])
            for k in ("num_outlier", "source_chamfer", "target_chamfer",
                      "target_nre"):
                _, targeted, untargeted = res["quantities"][k]
                agg_t[k].append(targeted)
                agg_u[k].append(untargeted)
            ftar.write(f"Shape class: {pc_class_name}\n")
            funtar.write(f"Shape class: {pc_class_name}\n")

    # over-classes eval_stats (reference :368-382)
    with open(osp.join(over_dir, "eval_stats.txt"), "w", 1) as fout:
        fout.write("Targeted attacks\n")
        fout.write("================\n")
        write_attack_statistics_to_file(
            fout, class_names, agg_t["norm"], agg_t["num_outlier"],
            agg_t["source_chamfer"], agg_t["target_chamfer"],
            agg_t["target_nre"],
        )
        fout.write("\nUntargeted attacks\n")
        fout.write("==================\n")
        write_attack_statistics_to_file(
            fout, class_names,
            [v.reshape(-1, 1) for v in agg_u["norm"]],
            [v.reshape(-1, 1) for v in agg_u["num_outlier"]],
            [v.reshape(-1, 1) for v in agg_u["source_chamfer"]],
            [v.reshape(-1, 1) for v in agg_u["target_chamfer"]],
            [v.reshape(-1, 1) for v in agg_u["target_nre"]],
        )
    print("wrote", osp.join(over_dir, "eval_stats.txt"))


if __name__ == "__main__":
    main()
