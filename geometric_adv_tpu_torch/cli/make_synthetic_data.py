"""Generate a ShapeNet-like synthetic dataset as a PLY tree
(``geometric_adv_tpu/cli/make_synthetic_data.py``, same flags and files):
procedurally generated shape classes in the /class/model.ply layout the
later stages read, from the port's copy of the sampler."""

import argparse
import os.path as osp

from geometric_adv_tpu_torch.data.synthetic import SHAPE_CLASSES, make_shapenet_like_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument(
        "--data_folder", type=str, default="data/synthetic_2048"
    )
    parser.add_argument(
        "--class_names", nargs="+", default=list(SHAPE_CLASSES)
    )
    parser.add_argument("--n_per_class", type=int, default=40)
    parser.add_argument("--n_points", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    flags = parser.parse_args(argv)
    print("Make synthetic data flags:", flags)

    out = make_shapenet_like_dir(
        osp.join(flags.project_dir, flags.data_folder),
        class_names=flags.class_names,
        n_per_class=flags.n_per_class,
        n_points=flags.n_points,
        seed=flags.seed,
    )
    print(f"wrote {len(flags.class_names)} classes x {flags.n_per_class} "
          f"models to {out}")


if __name__ == "__main__":
    main()
