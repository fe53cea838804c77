"""Prepare attack indices: per-class random selection, latent-space NN, and
the all-pairs chamfer NN matrix
(``geometric_adv_tpu/cli/prepare_indices_for_attack.py``; reference:
attacker/prepare_indices_for_attack.py)."""

import argparse
import os.path as osp
import time

import numpy as np

from geometric_adv_tpu_torch.attack.pipeline import (
    get_rand_idx,
    latent_dist_matrix,
    sort_dist_mat,
)
from geometric_adv_tpu_torch.cli.common import (
    add_device_flag,
    eval_dir,
    list_files,
    resolve_device,
)
from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix
from geometric_adv_tpu_torch.utils.artifacts import load_data


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--get_rand_idx", type=int, default=0)
    parser.add_argument("--get_latent_nn_idx", type=int, default=0)
    parser.add_argument("--get_chamfer_nn_idx", type=int, default=0)
    parser.add_argument("--num_instance_per_class", type=int, default=100)
    parser.add_argument("--pair_block", type=int, default=512)
    parser.add_argument("--blocks_per_chunk", type=int, default=256)
    # > 0 selects the chunk-screened matrix, which is not ported yet
    parser.add_argument("--chamfer_screen_chunks", type=int, default=0)
    parser.add_argument("--chamfer_screen_k", type=int, default=8)
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Prepare indices flags:", flags)
    device = resolve_device(flags.device)

    data_path = eval_dir(flags.project_dir, flags.ae_folder)
    files = list_files(data_path)
    point_clouds, latent_vectors, pc_classes, slice_idx = load_data(
        data_path, files,
        ["point_clouds_test_set", "latent_vectors_test_set", "pc_classes",
         "slice_idx_test_set"],
    )
    slice_idx_file = [f for f in files if "slice_idx_test_set" in f][0]
    suffix = slice_idx_file.split("_")[-3:]  # ['test', 'set', '<oc>.npy']
    suffix[-1] = suffix[-1].replace(".npy", "")

    if flags.get_rand_idx:
        sel_idx = get_rand_idx(slice_idx, flags.num_instance_per_class)
        name = "_".join(
            ["sel_idx", "rand", str(flags.num_instance_per_class)] + suffix
        )
        np.save(osp.join(data_path, name), sel_idx)
        print("saved", name)

    if flags.get_latent_nn_idx:
        mat = latent_dist_matrix(latent_vectors)
        np.save(osp.join(data_path, "_".join(["latent_dist_mat"] + suffix)), mat)
        nn_idx = sort_dist_mat(mat, slice_idx)
        np.save(osp.join(data_path, "_".join(["latent_nn_idx"] + suffix)), nn_idx)
        print("saved latent_nn_idx")

    if flags.get_chamfer_nn_idx:
        t0 = time.time()
        mat = chamfer_distance_matrix(
            point_clouds, device, pair_block=flags.pair_block,
            blocks_per_chunk=flags.blocks_per_chunk, progress=True,
            screen_chunks=flags.chamfer_screen_chunks,
        )
        n_pairs = len(point_clouds) * (len(point_clouds) + 1) // 2
        dt = time.time() - t0
        print(
            f"chamfer matrix {mat.shape} in {dt:.1f}s "
            f"({n_pairs / dt:.0f} pair-evals/s)"
        )
        np.save(
            osp.join(data_path, "_".join(["chamfer_dist_mat_complete"] + suffix)),
            mat,
        )
        nn_idx = sort_dist_mat(mat, slice_idx)
        np.save(
            osp.join(data_path, "_".join(["chamfer_nn_idx_complete"] + suffix)),
            nn_idx,
        )
        print("saved chamfer_nn_idx_complete")


if __name__ == "__main__":
    main()
