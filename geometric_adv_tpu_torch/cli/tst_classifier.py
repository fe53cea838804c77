"""Classifier test-set accuracy (``geometric_adv_tpu/cli/tst_classifier.py``;
reference: classifier/tst_classifier.py)."""

import argparse
import os.path as osp

from geometric_adv_tpu_torch.classify import ClassifierTrainer
from geometric_adv_tpu_torch.cli.common import (
    add_device_flag,
    eval_dir,
    list_files,
    resolve_device,
)
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.utils.artifacts import load_data


def main(argv=None):
    """-> (the test-set accuracy, {class name: accuracy})."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--classifier_folder", type=str, default="log/pointnet")
    parser.add_argument("--classifier_restore_epoch", type=int, default=None)
    parser.add_argument("--ae_folder", type=str, default="log/autoencoder_victim")
    parser.add_argument("--project_dir", type=str, default=".")
    add_device_flag(parser)
    flags = parser.parse_args(argv)
    print("Test classifier flags:", flags)
    device = resolve_device(flags.device)

    conf = Configuration.load(
        osp.join(flags.project_dir, flags.ae_folder, "configuration")
    )
    data_path = eval_dir(flags.project_dir, flags.ae_folder)
    files = list_files(data_path)
    point_clouds, pc_label = load_data(
        data_path, files, ["point_clouds_test_set", "pc_label_test_set"]
    )

    trainer = ClassifierTrainer(num_classes=len(conf.class_names), device=device)
    trainer.restore(
        osp.join(flags.project_dir, flags.classifier_folder),
        flags.classifier_restore_epoch,
    )
    pred = trainer.classify(point_clouds)
    acc = float((pred == pc_label).mean())
    print(f"test accuracy: {acc:.4f}")
    per_class = {}
    for c, name in enumerate(conf.class_names):
        mask = pc_label == c
        if mask.any():
            per_class[name] = float((pred[mask] == c).mean())
    for name, a in per_class.items():
        print(f"  {name}: {a:.4f}")
    return acc, per_class


if __name__ == "__main__":
    main()
