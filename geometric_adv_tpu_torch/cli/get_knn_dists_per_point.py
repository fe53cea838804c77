"""kNN distance artifacts for the off-surface defense
(``geometric_adv_tpu/cli/get_knn_dists_per_point.py``; reference:
defender/get_knn_dists_per_point.py): per-point distances to the num_knn
nearest neighbors, for the best-dist-weight adversarial inputs and for the
clean sources (the _orig control), computed on ``--device`` (default
cuda)."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.attack.pipeline import get_quantity_at_index
from geometric_adv_tpu_torch.cli.common import (
    AttackContext,
    add_device_flag,
    ensure_dir,
    resolve_device,
)
from geometric_adv_tpu_torch.defense import knn_dists_per_point


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument("--attack_folder", type=str, default="attack_res")
    parser.add_argument("--num_knn", type=int, default=8)
    parser.add_argument(
        "--output_folder_name", type=str, default="defense_surface_res"
    )
    parser.add_argument("--project_dir", type=str, default=".")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Get knn dists flags:", flags)
    device = resolve_device(flags.device)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )
    output_path = ensure_dir(
        osp.join(ctx.attack_dir, flags.output_folder_name)
    )
    output_path_orig = ensure_dir(
        osp.join(ctx.attack_dir, flags.output_folder_name + "_orig")
    )

    for i, pc_class_name in ctx.classes_iter():
        load_dir = osp.join(ctx.attack_dir, pc_class_name)
        adversarial_pc_input = np.load(
            osp.join(load_dir, "adversarial_pc_input.npy")
        )
        norm_min_idx = np.load(
            osp.join(load_dir, "analysis_results", "source_target_norm_min_idx.npy")
        )
        adv = get_quantity_at_index([adversarial_pc_input], norm_min_idx)
        adv = np.expand_dims(adv, axis=0)  # keep dist_weight as first dim

        knn = np.stack(
            [knn_dists_per_point(adv[j], device, num_knn=flags.num_knn)
             for j in range(adv.shape[0])]
        )
        save_dir = ensure_dir(osp.join(output_path, pc_class_name))
        np.save(osp.join(save_dir, "knn_dists_adversarial_pc_input"), knn)

        source_pc, _ = ctx.class_attack_data(pc_class_name, ctx.point_clouds)
        knn_src = knn_dists_per_point(source_pc, device, num_knn=flags.num_knn)
        save_dir_orig = ensure_dir(osp.join(output_path_orig, pc_class_name))
        np.save(osp.join(save_dir_orig, "knn_dists_source_pc"), knn_src)
        print(f"{pc_class_name}: knn dists {knn.shape} / {knn_src.shape}")


if __name__ == "__main__":
    main()
