"""Train the PointNet classifier (``geometric_adv_tpu/cli/train_classifier.py``;
reference: classifier/train_classifier.py).

Trains on the dataset's train split, saving a checkpoint every
``--saver_step`` epochs, then writes the test-set predicted labels
(``pc_pred_labels_test_set``) into the victim's eval folder, which
``run_attack --correct_pred_only 1`` reads."""

import argparse
import os.path as osp

import numpy as np

from geometric_adv_tpu_torch.classify import ClassifierTrainer
from geometric_adv_tpu_torch.cli.common import (
    add_device_flag,
    ensure_dir,
    eval_dir,
    list_files,
    resolve_device,
)
from geometric_adv_tpu_torch.data.augment import sort_axes
from geometric_adv_tpu_torch.data.datasets import load_dataset
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.utils.artifacts import load_data


def main(argv=None):
    """-> the trainer's [(epoch, loss, accuracy, seconds)]."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--max_epoch", type=int, default=150)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--bn_momentum", type=float, default=0.9)
    parser.add_argument("--train_folder", type=str, default="log/pointnet")
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--project_dir", type=str, default=".")
    parser.add_argument("--data_folder", type=str, default="data/synthetic_2048")
    parser.add_argument("--saver_step", type=int, default=10)
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Train classifier flags:", flags)
    device = resolve_device(flags.device)

    conf = Configuration.load(
        osp.join(flags.project_dir, flags.ae_folder, "configuration")
    )
    top_in_dir = osp.join(flags.project_dir, flags.data_folder)
    train_dir = ensure_dir(osp.join(flags.project_dir, flags.train_folder))

    pcs, _, labels = load_dataset(conf.class_names, "train_set", top_in_dir)
    pcs = sort_axes(pcs) if conf.sort_axes else pcs

    trainer = ClassifierTrainer(
        num_classes=len(conf.class_names),
        batch_size=flags.batch_size,
        base_lr=flags.learning_rate,
        bn_momentum=flags.bn_momentum,
        device=device,
    )
    stats = []
    with open(osp.join(train_dir, "log_train.txt"), "a", 1) as log:
        for start in range(0, flags.max_epoch, flags.saver_step):
            n = min(flags.saver_step, flags.max_epoch - start)
            stats += trainer.train(pcs, np.asarray(labels), epochs=n, log_file=log)
            trainer.save(train_dir)

    # test-set predictions artifact for correct_pred_only filtering
    data_path = eval_dir(flags.project_dir, flags.ae_folder)
    if osp.isdir(data_path):
        files = list_files(data_path)
        test_pcs = load_data(data_path, files, ["point_clouds_test_set"])
        pred = trainer.classify(test_pcs)
        suffix = [
            f for f in files if "point_clouds_test_set" in f
        ][0].replace("point_clouds_", "pc_pred_labels_")
        np.save(osp.join(data_path, suffix), pred)
        print("saved", suffix)
    return stats


if __name__ == "__main__":
    main()
