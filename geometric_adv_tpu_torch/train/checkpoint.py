"""Checkpoint save/restore of the port's victim AE.

Same ``train_dir`` layout as ``geometric_adv_tpu/train/checkpoint.py``: the
checkpoint of epoch E lives under ``<train_dir>/checkpoints/``, here as the
file ``E.pt`` (``torch.save`` of the model's state dict, the epoch and, from
a training run, the Adam optimizer's state dict) beside the JAX package's
orbax directory ``E``. Each package's ``latest_epoch`` sees only its own
kind, so both can share one ``train_dir``.
"""

from __future__ import annotations

import os

import torch

CHECKPOINT_SUBDIR = "checkpoints"


def checkpoint_path(train_dir: str, epoch: int) -> str:
    return os.path.join(
        os.path.abspath(train_dir), CHECKPOINT_SUBDIR, f"{int(epoch)}.pt"
    )


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(train_dir: str, epoch: int, state_dict: dict,
                    opt_state: dict | None = None) -> str:
    path = checkpoint_path(train_dir, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(
        {"state_dict": _to_cpu(state_dict), "epoch": int(epoch),
         "opt_state": _to_cpu(opt_state)},
        tmp,
    )
    os.replace(tmp, path)
    return path


def restore_checkpoint(train_dir: str, epoch: int) -> dict:
    """-> {"state_dict": {name: CPU tensor}, "epoch": int, "opt_state":
    the optimizer's state dict or None}."""
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
