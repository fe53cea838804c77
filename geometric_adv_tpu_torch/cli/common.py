"""Shared CLI plumbing: device selection, eval-artifact loading and the
attack context (``geometric_adv_tpu/cli/common.py`` without its multi-host
wiring, which is ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from geometric_adv_tpu_torch.attack.pipeline import prepare_data_for_attack
from geometric_adv_tpu_torch.data.datasets import create_dir
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.utils.artifacts import load_data

NN_IDX_DICT = {
    "latent_nn": "latent_nn_idx_test_set",
    "chamfer_nn_complete": "chamfer_nn_idx_complete_test_set",
}


def add_device_flag(parser) -> None:
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device the stage runs on; 'cuda' raises if CUDA is absent",
    )


def resolve_device(name: str, matmul_precision: str | None = None) -> torch.device:
    """The stage's device. There is no silent move to the CPU: asking for
    CUDA where it is absent raises. Float32 matmuls and convolutions are
    pinned to full precision (no TF32), the JAX package's f32 semantics;
    ``--matmul_precision`` accepts only values that keep that."""
    if matmul_precision not in (None, "float32", "highest"):
        raise NotImplementedError(
            f"--matmul_precision {matmul_precision}: the port computes in "
            "full float32 only"
        )
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def eval_dir(project_dir: str, ae_folder: str) -> str:
    return osp.join(project_dir, ae_folder, "eval")


def list_files(data_path: str):
    return [
        f for f in os.listdir(data_path) if osp.isfile(osp.join(data_path, f))
    ]


class AttackContext:
    """Everything the attack and defense stages share."""

    def __init__(self, project_dir, ae_folder, attack_folder=None,
                 attack_pc_idx=None, num_pc_for_attack=None):
        self.project_dir = project_dir
        self.ae_dir = osp.join(project_dir, ae_folder)
        self.data_path = eval_dir(project_dir, ae_folder)
        self.files = list_files(self.data_path)

        (self.point_clouds, self.latent_vectors, self.pc_classes,
         self.slice_idx, self.ae_loss) = load_data(
            self.data_path, self.files,
            ["point_clouds_test_set", "latent_vectors_test_set", "pc_classes",
             "slice_idx_test_set", "ae_loss_test_set"],
        )
        if not np.all(self.ae_loss > 0):
            raise ValueError("not all autoencoder loss values are larger than 0")
        try:  # the defense's replay checks read them
            self.reconstructions = load_data(
                self.data_path, self.files, ["reconstructions_test_set"]
            )
        except FileNotFoundError:
            self.reconstructions = None

        self.attack_dir = (
            osp.join(self.data_path, attack_folder) if attack_folder else None
        )
        if self.attack_dir and osp.exists(
            osp.join(self.attack_dir, "attack_configuration.json")
        ):
            self.conf = Configuration.load(
                osp.join(self.attack_dir, "attack_configuration")
            )
        else:
            self.conf = Configuration.load(osp.join(self.ae_dir, "configuration"))

        self.nn_idx = None
        if self.conf.target_pc_idx_type in NN_IDX_DICT:
            try:
                self.nn_idx = load_data(
                    self.data_path, self.files,
                    [NN_IDX_DICT[self.conf.target_pc_idx_type]],
                )
            except FileNotFoundError:
                pass

        self.correct_pred = None
        if self.conf.correct_pred_only:
            self.load_correct_pred()

        self.attack_pc_idx = None
        if attack_pc_idx:
            idx = np.load(osp.join(project_dir, attack_pc_idx))
            n = num_pc_for_attack or self.conf.num_pc_for_attack
            self.attack_pc_idx = idx[:, :n]

    def load_correct_pred(self) -> None:
        pc_labels, pc_pred_labels = load_data(
            self.data_path, self.files,
            ["pc_label_test_set", "pc_pred_labels_test_set"],
        )
        self.correct_pred = pc_labels == pc_pred_labels

    def class_attack_data(self, class_name, data, num_pc_for_target=None):
        """Pair-grid rows of ``data`` for one source class
        (reference: attacker/run_attack.py:127-129)."""
        return prepare_data_for_attack(
            self.pc_classes,
            [class_name],
            list(self.conf.class_names),
            data,
            self.slice_idx,
            self.attack_pc_idx,
            num_pc_for_target or self.conf.num_pc_for_target,
            self.nn_idx,
            self.correct_pred,
        )

    def classes_iter(self):
        for i, name in enumerate(self.pc_classes):
            if name in self.conf.class_names:
                yield i, str(name)


def restore_victim(conf: Configuration, ae_dir: str, device, restore_epoch=None):
    """Build + restore the victim AE from a port checkpoint
    (reference: run_attack.py:120-122)."""
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    return AETrainer(conf, device).restore(ae_dir, restore_epoch)


def ensure_dir(path: str) -> str:
    return create_dir(path)
