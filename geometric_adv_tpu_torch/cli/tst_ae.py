"""Produce the eval artifact set every later stage consumes
(``geometric_adv_tpu/cli/tst_ae.py``; reference: autoencoder/tst_ae.py):
point clouds, latents, reconstructions, per-pc loss, slice_idx, labels,
class names."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.cli.common import (
    add_device_flag,
    ensure_dir,
    resolve_device,
    restored_tf32_flags,
)
from geometric_adv_tpu_torch.data.augment import sort_axes
from geometric_adv_tpu_torch.data.datasets import load_dataset
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.train.trainer import AETrainer


def main(argv=None):
    with restored_tf32_flags():
        return _run(argv)


def _run(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_epoch", type=int, default=None)
    parser.add_argument("--set_type", type=str, default="test_set",
                        choices=["train_set", "val_set", "test_set"])
    parser.add_argument(
        "--train_folder", type=str, default="log/autoencoder_victim"
    )
    parser.add_argument("--output_folder_name", type=str, default="eval")
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--data_folder", type=str, default="data/synthetic_2048")
    parser.add_argument("--matmul_precision", type=str, default=None)
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Test autoencoder flags:", flags)
    device = resolve_device(flags.device, flags.matmul_precision)

    top_in_dir = osp.join(flags.project_dir, flags.data_folder)
    train_dir = osp.join(flags.project_dir, flags.train_folder)
    conf = Configuration.load(osp.join(train_dir, "configuration"))

    point_clouds, slice_idx, pc_label = load_dataset(
        conf.class_names, flags.set_type, top_in_dir
    )
    if conf.sort_axes:
        point_clouds = sort_axes(point_clouds)

    trainer = AETrainer(conf, device).restore(train_dir, flags.restore_epoch)

    eval_dir = ensure_dir(osp.join(train_dir, flags.output_folder_name))
    oc = list(conf.object_class)
    st = flags.set_type

    def save(base, data, with_set=True):
        parts = [base] + ([st] if with_set else []) + oc
        np.save(osp.join(eval_dir, "_".join(parts) + ".npy"), data)

    save("pc_classes", np.array(conf.class_names), with_set=False)
    save("pc_label", np.array(pc_label).astype(np.int8))
    save("slice_idx", np.array(slice_idx))
    save("point_clouds", point_clouds)
    save("latent_vectors", trainer.get_latent_vectors(point_clouds))
    save("reconstructions", trainer.get_reconstructions(point_clouds))
    loss_per_pc = trainer.get_loss_per_pc(point_clouds)
    save("ae_loss", loss_per_pc)

    with open(
        osp.join(eval_dir, "_".join(["eval_stats", st] + oc) + ".txt"), "w", 1
    ) as log:
        log.write("Mean ae loss: %.9f\n" % loss_per_pc.mean())
    print("Mean ae loss: %.9f" % loss_per_pc.mean())


if __name__ == "__main__":
    main()
