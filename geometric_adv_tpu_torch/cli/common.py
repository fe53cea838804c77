"""Shared CLI plumbing: device selection, eval-artifact loading, the
attack context and the multi-process wiring
(``geometric_adv_tpu/cli/common.py``).
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp

import numpy as np
import torch

from geometric_adv_tpu_torch.attack.pipeline import prepare_data_for_attack
from geometric_adv_tpu_torch.data.datasets import create_dir
from geometric_adv_tpu_torch.parallel import maybe_initialize_from_env
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.utils.artifacts import load_data

# Multi-process wiring for every pipeline CLI: when the GAT_*/JAX_* variables
# name a group of several processes, it comes up (gloo, each rank on its
# card) before any stage touches a device, so that get_mesh() spans it. A
# no-op otherwise.
maybe_initialize_from_env()

NN_IDX_DICT = {
    "latent_nn": "latent_nn_idx_test_set",
    "chamfer_nn_complete": "chamfer_nn_idx_complete_test_set",
}


def add_device_flag(parser) -> None:
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device the stage runs on; 'cuda' raises if CUDA is absent",
    )


# --matmul_precision: the strings the JAX package passes to
# jax_default_matmul_precision -> whether the card's float32 matmuls (cuBLAS)
# and convolutions (cuDNN) may run on TF32 tensor cores (10-bit mantissa
# inputs, float32 accumulation):
# - None, "float32", "highest": no TF32, full float32 (the port's default and
#   the JAX package's strict 1e-6 replay setting);
# - "tensorfloat32", "high", "bfloat16_3x": TF32 ("bfloat16_3x" is three
#   bfloat16 passes on a TPU; the card's nearest float32 path is TF32);
# - "bfloat16", "default": also TF32. A single bfloat16 pass over float32
#   operands is a TPU mode; cuBLAS has none (``set_float32_matmul_precision``
#   "medium" turns on TF32 on CUDA as well). A bfloat16 victim is
#   ``ae_dtype="bfloat16"``, not a matmul precision.
# On the CPU every string computes full float32, as XLA:CPU ignores the
# precision too.
MATMUL_PRECISION_TF32 = {
    None: False, "float32": False, "highest": False,
    "tensorfloat32": True, "high": True, "bfloat16_3x": True,
    "bfloat16": True, "default": True,
}


def matmul_tf32(matmul_precision: str | None, device_type: str) -> bool:
    """Whether ``--matmul_precision`` puts a ``device_type`` stage's float32
    matmuls on TF32; ValueError on a string the JAX package does not take."""
    if matmul_precision not in MATMUL_PRECISION_TF32:
        raise ValueError(
            f"--matmul_precision {matmul_precision!r}: expected one of "
            f"{sorted(k for k in MATMUL_PRECISION_TF32 if k)}"
        )
    return device_type == "cuda" and MATMUL_PRECISION_TF32[matmul_precision]


def resolve_device(name: str, matmul_precision: str | None = None) -> torch.device:
    """The stage's device. There is no silent move to the CPU: asking for
    CUDA where it is absent raises. Sets the process-wide TF32 flags from
    this stage's ``--matmul_precision`` (``matmul_tf32``), so that one
    stage's setting never carries into the next stage of the process."""
    device = torch.device(name)
    tf32 = matmul_tf32(matmul_precision, device.type)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return device


@contextlib.contextmanager
def restored_tf32_flags():
    """Puts the TF32 flags back as they were on entry: the stages that take
    ``--matmul_precision`` run inside it, so that their setting ends with
    them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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


def restore_victim(conf: Configuration, ae_dir: str, device, restore_epoch=None,
                   mesh=None):
    """Build + restore the victim AE from a port checkpoint, every rank of
    ``mesh`` the same one (reference: run_attack.py:120-122)."""
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    return AETrainer(conf, device, mesh=mesh).restore(ae_dir, restore_epoch)


def ensure_dir(path: str) -> str:
    return create_dir(path)
