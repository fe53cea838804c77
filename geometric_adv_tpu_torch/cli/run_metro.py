"""Metro (mesh-to-mesh Hausdorff) eval of the AtlasNet transfer AE
(``geometric_adv_tpu/cli/run_metro.py``; reference:
transfer/atlasnet/training/trainer_loss.py:60-101, training/metro.py:14-32).

``atlasnet_generate_mesh`` deforms the SQUARE template grids and carries
their triangulation; ``metro_distance`` samples both surfaces and takes the
symmetric Hausdorff of the samples, on the card through K2
(transfer/metro.py). The ground truth is the synthetic dataset's analytic
meshes: ``sample_shape_and_mesh`` rebuilds each instance's parametric surface
mesh in its cloud's normalised frame (only MESHABLE_CLASSES have one), for
fresh instances drawn with ``--seed``."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.cli.common import add_device_flag, ensure_dir, resolve_device
from geometric_adv_tpu_torch.data.synthetic import (
    MESHABLE_CLASSES,
    sample_shape_and_mesh,
)
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.transfer import get_transfer_ae, load_transfer_arch
from geometric_adv_tpu_torch.transfer.metro import metro_eval


def main(argv=None):
    """-> [(class name, distance)] per mesh pair."""
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--transfer_ae_folder", type=str, default="log/atlasnet_for_transfer"
    )
    parser.add_argument("--transfer_ae_restore_epoch", type=int, default=None)
    parser.add_argument(
        "--ae_folder", type=str, default="log/autoencoder_victim"
    )
    parser.add_argument(
        "--class_names", nargs="+", default=None,
        help="meshable synthetic classes to evaluate (default: the "
        "intersection of the victim's classes with MESHABLE_CLASSES)",
    )
    parser.add_argument("--num_per_class", type=int, default=2)
    parser.add_argument(
        "--n_samples", type=int, default=30_000,
        help="surface samples per side of each Hausdorff evaluation "
        "(the reference metro default scale; transfer/metro.py)",
    )
    parser.add_argument("--seed", type=int, default=17)
    parser.add_argument("--project_dir", type=str, default=".")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Run metro flags:", flags)
    device = resolve_device(flags.device)

    conf = Configuration.load(
        osp.join(flags.project_dir, flags.ae_folder, "configuration")
    )
    classes = flags.class_names or [
        c for c in conf.class_names if c in MESHABLE_CLASSES
    ]
    if not classes:
        raise SystemExit(
            "no meshable classes to evaluate (see "
            "data/synthetic.py::MESHABLE_CLASSES)"
        )

    transfer_dir = osp.join(flags.project_dir, flags.transfer_ae_folder)
    arch = load_transfer_arch(transfer_dir) or {}
    arch.pop("ae_type", None)
    trainer = get_transfer_ae("atlasnet", device=device, **arch)
    if trainer.model.template_type != "SQUARE":
        raise SystemExit(
            "metro mesh generation needs the SQUARE template (grid "
            "triangulation); this checkpoint was trained with "
            f"{trainer.model.template_type}"
        )
    trainer.restore(transfer_dir, flags.transfer_ae_restore_epoch)
    print("Checkpoint successfully loaded")

    rng = np.random.RandomState(flags.seed)
    out_dir = ensure_dir(osp.join(transfer_dir, "eval"))
    per_class = {}
    rows = []
    for name in classes:
        clouds, meshes = [], []
        for _ in range(flags.num_per_class):
            pc, mesh = sample_shape_and_mesh(name, conf.n_points, rng)
            if mesh is None:
                raise SystemExit(f"class {name!r} has no analytic mesh")
            clouds.append(pc)
            meshes.append(mesh)
        mean, per = metro_eval(
            trainer, clouds, meshes,
            n_samples=flags.n_samples, seed=flags.seed,
        )
        per_class[name] = mean
        rows += [(name, d) for d in per]
        print(f"metro {name}: mean {mean:.6f} ({per})")

    over = float(np.mean([d for _, d in rows]))
    np.save(
        osp.join(out_dir, "metro_distances.npy"),
        np.asarray([d for _, d in rows], np.float32),
    )
    with open(osp.join(out_dir, "metro_stats.txt"), "w", 1) as f:
        f.write("Metro (sampled mesh Hausdorff) per class\n")
        for name in classes:
            f.write(f"{name}: {per_class[name]:.6f}\n")
        f.write(f"over classes: {over:.6f}\n")
    print(f"metro over classes: {over:.6f}")
    return rows


if __name__ == "__main__":
    main()
