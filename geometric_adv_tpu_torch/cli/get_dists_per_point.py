"""Per-adversarial-point distance to the source cloud
(``geometric_adv_tpu/cli/get_dists_per_point.py``; reference:
attacker/get_dists_per_point.py) — sqrt of the NN squared distance, saved as
adversarial_pc_input_dists.npy per class."""

import argparse
import os.path as osp

import numpy as np
import torch

from geometric_adv_tpu_torch.cli.common import (
    AttackContext,
    add_device_flag,
    resolve_device,
)
from geometric_adv_tpu_torch.ops.chamfer import nn_distance


@torch.no_grad()
def dists_per_point(adv, src, device) -> np.ndarray:
    d1, _, _, _ = nn_distance(
        torch.as_tensor(adv, device=device), torch.as_tensor(src, device=device)
    )
    return d1.clamp(min=0.0).sqrt().cpu().numpy()  # sqrt at reference :122


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--attack_pc_idx", type=str, required=True)
    parser.add_argument(
        "--attack_folder", "--output_folder_name", dest="attack_folder",
        type=str, default="attack_res",
        help="attack output dir (reference flag name: --output_folder_name)",
    )
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--batch_size", type=int, default=100)
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Get dists per point flags:", flags)
    device = resolve_device(flags.device)

    ctx = AttackContext(
        flags.project_dir, flags.ae_folder, attack_folder=flags.attack_folder,
        attack_pc_idx=flags.attack_pc_idx,
    )

    for _, pc_class_name in ctx.classes_iter():
        load_dir = osp.join(ctx.attack_dir, pc_class_name)
        adversarial_pc_input = np.load(
            osp.join(load_dir, "adversarial_pc_input.npy")
        )
        source_pc, _ = ctx.class_attack_data(pc_class_name, ctx.point_clouds)

        dists = np.zeros(adversarial_pc_input.shape[:-1], np.float32)
        for j in range(adversarial_pc_input.shape[0]):
            for s in range(0, len(source_pc), flags.batch_size):
                sl = slice(s, s + flags.batch_size)
                dists[j, sl] = dists_per_point(
                    adversarial_pc_input[j, sl].astype(np.float32),
                    source_pc[sl].astype(np.float32), device,
                )
        np.save(osp.join(load_dir, "adversarial_pc_input_dists"), dists)
        print(f"{pc_class_name}: saved adversarial_pc_input_dists "
              f"{dists.shape}")


if __name__ == "__main__":
    main()
