"""The inference half of the AE trainer: build, restore and batched
forward passes of the victim (``geometric_adv_tpu/train/trainer.py``
``AETrainer``, :155-257).

Inference runs in eval mode in batches of 250 clouds under ``no_grad``;
results come back as numpy. Training (Adam, BN train mode, augmentation) is
ROADMAP Queue 1 item 3, and the EMD loss is item 11.
"""

from __future__ import annotations

import numpy as np
import torch

from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE, init_weights
from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
from geometric_adv_tpu_torch.train import checkpoint as ckpt
from geometric_adv_tpu_torch.train.config import Configuration


class AETrainer:
    """Owns the victim model on ``device``; seeded init, then ``restore``."""

    def __init__(self, conf: Configuration, device, seed: int = 42):
        if conf.loss != "chamfer":
            raise NotImplementedError(
                f"--loss {conf.loss}: the EMD loss is not ported yet "
                "(ROADMAP Queue 1 item 11)"
            )
        if (conf.ae_dtype or "float32") != "float32":
            raise NotImplementedError(
                f"ae_dtype {conf.ae_dtype!r}: the port computes in float32 only"
            )
        self.conf = conf
        self.device = torch.device(device)
        model = PointNetAE(
            n_points=conf.n_points,
            bneck_size=conf.bneck_size,
            encoder_filters=conf.encoder_filters,
            decoder_sizes=conf.decoder_sizes,
        )
        init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.epoch = 0

    def save(self, train_dir, epoch=None):
        epoch = self.epoch if epoch is None else epoch
        return ckpt.save_checkpoint(train_dir, epoch, self.model.state_dict())

    def restore(self, train_dir, epoch=None):
        if epoch is None:
            epoch = ckpt.latest_epoch(train_dir)
        if epoch is None:
            raise FileNotFoundError(f"no port checkpoints under {train_dir}")
        tree = ckpt.restore_checkpoint(train_dir, epoch)
        self.model.load_state_dict(tree["state_dict"])
        self.epoch = int(tree["epoch"])
        return self

    @torch.no_grad()
    def _batched_forward(self, pclouds, gt=None, batch_size=250,
                         outputs=("recon", "z", "pre", "loss")):
        """Chunked eval-mode inference; only the requested ``outputs`` are
        copied to the host."""
        gt = pclouds if gt is None else gt
        outs = {k: [] for k in outputs}
        for s in range(0, len(pclouds), batch_size):
            xb = torch.as_tensor(
                np.asarray(pclouds[s : s + batch_size], np.float32),
                device=self.device,
            )
            recon, z, pre = self.model(xb)
            results = {"recon": recon, "z": z, "pre": pre}
            if "loss" in outputs:
                gb = torch.as_tensor(
                    np.asarray(gt[s : s + batch_size], np.float32),
                    device=self.device,
                )
                results["loss"] = chamfer_loss_per_pc(recon, gb)
            for k in outputs:
                outs[k].append(results[k].cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}

    def get_reconstructions(self, pclouds, batch_size=250):
        return self._batched_forward(
            pclouds, batch_size=batch_size, outputs=("recon",)
        )["recon"]

    def get_latent_vectors(self, pclouds, batch_size=250):
        return self._batched_forward(
            pclouds, batch_size=batch_size, outputs=("z",)
        )["z"]

    def get_loss_per_pc(self, feed_data, orig_data=None, batch_size=250):
        return self._batched_forward(
            feed_data, orig_data, batch_size=batch_size, outputs=("loss",)
        )["loss"]
