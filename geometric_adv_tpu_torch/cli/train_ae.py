"""Train the victim autoencoder (``geometric_adv_tpu/cli/train_ae.py``;
reference: autoencoder/train_ae.py).

Same flags, ``configuration.json``/``.txt``, data preparation (``sort_axes``,
the cross-class shuffle with seed 55) and ``train_stats.txt`` as the JAX
stage, plus ``--device``. Started in several processes (the ``GAT_``
variables, ``cli/common.py``), it trains under the mesh of all of them
(``AETrainer``: each rank steps on its rows of every batch, batch norm over
the global batch, the gradients summed over the ranks), as the JAX stage
does over several processes. The primary alone writes ``configuration``,
``train_stats.txt`` and the checkpoints; every rank prints the epoch
lines."""

import argparse
import contextlib
import os
import os.path as osp

from geometric_adv_tpu_torch.cli.common import (
    add_device_flag,
    ensure_dir,
    resolve_device,
)
from geometric_adv_tpu_torch.data.augment import sort_axes
from geometric_adv_tpu_torch.data.datasets import PointCloudDataSet, load_dataset
from geometric_adv_tpu_torch.data.synthetic import SHAPE_CLASSES
from geometric_adv_tpu_torch.parallel import get_mesh, is_primary
from geometric_adv_tpu_torch.train.config import Configuration, default_train_params
from geometric_adv_tpu_torch.train.trainer import AETrainer

REFERENCE_CLASS_NAMES = [
    "table", "car", "chair", "airplane", "sofa", "rifle", "lamp",
    "watercraft", "bench", "loudspeaker", "cabinet", "display", "telephone",
]


def main(argv=None):
    """-> the trainer's [(epoch, loss, seconds)], None with
    ``--save_config_and_exit``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--training_epochs", type=int, default=500)
    parser.add_argument("--save_config_and_exit", type=int, default=0)
    parser.add_argument("--sort_axes", type=int, default=1)
    parser.add_argument(
        "--train_folder", type=str, default="log/autoencoder_victim"
    )
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument(
        "--data_folder", type=str, default="data/synthetic_2048",
        help="ShapeNetCore-style PLY tree (class dirs of .ply models)",
    )
    parser.add_argument(
        "--class_names", nargs="+", default=None,
        help="default: the 13 reference classes if present in data_folder, "
        "else the synthetic classes",
    )
    parser.add_argument("--n_points", type=int, default=2048)
    parser.add_argument("--bneck_size", type=int, default=128)
    parser.add_argument("--loss", type=str, default="chamfer")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--object_class", nargs="+", default=["13l"])
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Train autoencoder flags:", flags)
    device = resolve_device(flags.device)
    # the mesh of every process where the group has several; one process
    # is a mesh of size 1, which the trainer treats as none
    mesh = get_mesh()

    top_in_dir = osp.join(flags.project_dir, flags.data_folder)
    train_dir = ensure_dir(osp.join(flags.project_dir, flags.train_folder))

    class_names = flags.class_names
    if class_names is None:
        present = set(os.listdir(top_in_dir)) if osp.isdir(top_in_dir) else set()
        if set(REFERENCE_CLASS_NAMES) <= present:
            class_names = REFERENCE_CLASS_NAMES
        else:
            class_names = [c for c in SHAPE_CLASSES if c in present] or list(
                SHAPE_CLASSES
            )

    params = default_train_params()
    conf = Configuration(
        n_input=[flags.n_points, 3],
        loss=flags.loss,
        bneck_size=flags.bneck_size,
        training_epochs=flags.training_epochs,
        batch_size=flags.batch_size or params["batch_size"],
        learning_rate=flags.learning_rate or params["learning_rate"],
        train_dir=train_dir,
        saver_step=params["saver_step"],
        loss_display_step=params["loss_display_step"],
        z_rotate=params["z_rotate"],
        is_denoising=params["denoising"],
        experiment_name="autoencoder",
        object_class=flags.object_class,
        class_names=class_names,
        sort_axes=bool(flags.sort_axes),
        held_out_step=5,
    )
    if is_primary():
        conf.save(osp.join(train_dir, "configuration"))
    if flags.save_config_and_exit:
        return

    sets = []
    for set_type in ("train_set", "val_set"):
        pcs, _, _ = load_dataset(class_names, set_type, top_in_dir)
        if flags.sort_axes and len(pcs):
            pcs = sort_axes(pcs)
        data = PointCloudDataSet(pcs, init_shuffle=False)
        if len(class_names) > 1:
            # cross-class shuffle, seed 55 (reference: train_ae.py:103-105)
            data.shuffle_data(seed=55)
        sets.append(data)
    pc_data_train, pc_data_val = sets

    trainer = AETrainer(conf, device, mesh=mesh)
    stats_file = osp.join(train_dir, "train_stats.txt")
    with (open(stats_file, "a", 1) if is_primary()
          else contextlib.nullcontext()) as fout:
        return trainer.train(
            pc_data_train, conf, log_file=fout,
            held_out_data=pc_data_val if pc_data_val.num_examples else None,
        )


if __name__ == "__main__":
    main()
