"""Checkpoint save/restore of the port's victim AE.

Same ``train_dir`` layout as ``geometric_adv_tpu/train/checkpoint.py``: the
checkpoint of epoch E lives under ``<train_dir>/checkpoints/``, here as the
file ``E.pt`` (``torch.save`` of the model's state dict and the epoch) beside
the JAX package's orbax directory ``E``. Each package's ``latest_epoch``
sees only its own kind, so both can share one ``train_dir``. Optimizer state
comes with AE training (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import os

import torch

CHECKPOINT_SUBDIR = "checkpoints"


def checkpoint_path(train_dir: str, epoch: int) -> str:
    return os.path.join(
        os.path.abspath(train_dir), CHECKPOINT_SUBDIR, f"{int(epoch)}.pt"
    )


def save_checkpoint(train_dir: str, epoch: int, state_dict: dict) -> str:
    path = checkpoint_path(train_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(
        {"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
         "epoch": int(epoch)},
        tmp,
    )
    os.replace(tmp, path)
    return path


def restore_checkpoint(train_dir: str, epoch: int) -> dict:
    """-> {"state_dict": {name: CPU tensor}, "epoch": int}."""
    return torch.load(
        checkpoint_path(train_dir, epoch), map_location="cpu", weights_only=True
    )


def latest_epoch(train_dir: str) -> int | None:
    root = os.path.join(os.path.abspath(train_dir), CHECKPOINT_SUBDIR)
    if not os.path.isdir(root):
        return None
    epochs = [
        int(f[:-3]) for f in os.listdir(root)
        if f.endswith(".pt") and f[:-3].isdigit()
    ]
    return max(epochs) if epochs else None
