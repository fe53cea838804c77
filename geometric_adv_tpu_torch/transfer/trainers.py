"""Training and inference of the transfer autoencoders
(``geometric_adv_tpu/transfer/trainers.py``; reference: the AtlasNet
trainer, transfer/atlasnet/training/trainer.py:25, atlasnet_ae.py:27-88, and
the FoldingNet script, transfer/foldingnet/train_foldingnet.py).

A train step is forward in BN train mode, the loss
``mean(chamfer_loss_per_pc(recon, x))`` through the port's chamfer op (on
the card K1 forward and K3 backward: the decoders' 2500 and 2025 points are
above the fused loss's gate), backward and one Adam update with optax's
defaults at a constant rate. An epoch runs over device-resident clouds in
the order of an on-device permutation from a generator seeded with the
epoch's number, which also draws AtlasNet's random templates. Inference runs
in eval mode (AtlasNet on its regular template) under ``no_grad``; results
come back as numpy. Checkpoints are the port's ``train/checkpoint.py``
format; ``arch.json`` records the architecture beside them.
"""

from __future__ import annotations

import json
import os.path as osp
import time

import numpy as np
import torch

from geometric_adv_tpu_torch.models.atlasnet import AtlasNet, random_template_points
from geometric_adv_tpu_torch.models.foldingnet import FoldingNet, graph_features
from geometric_adv_tpu_torch.models.pointnet_ae import init_weights
from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
from geometric_adv_tpu_torch.train import checkpoint as ckpt


class _TransferTrainerBase:
    """Seeded init, Adam, the chamfer train step, batched inference and
    checkpoints; subclasses define ``_train_step(x, gen)`` (one Adam step
    through ``_step``) and ``_forward_eval(x)`` (the reconstruction)."""

    def __init__(self, model, learning_rate, device, seed=0):
        self.device = torch.device(device)
        init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.epoch = 0

    def _step(self, x: torch.Tensor, recon_fn):
        self.model.train()
        recon = recon_fn()
        loss = chamfer_loss_per_pc(recon, x).mean()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.model.eval()
        return loss.detach()

    def _device_epoch(self, pcs: torch.Tensor, n_batches: int, batch_size: int):
        gen = torch.Generator(device=self.device).manual_seed(self.epoch + 1)
        perm = torch.randperm(pcs.shape[0], generator=gen,
                              device=self.device)[: n_batches * batch_size]
        losses = [self._train_step(pcs[perm[i * batch_size:(i + 1) * batch_size]], gen)
                  for i in range(n_batches)]
        return float(torch.stack(losses).mean()) if losses else 0.0

    def train(self, point_clouds, epochs, batch_size, log_file=None,
              tag="transfer", held_out=None, val_step=1):
        """``epochs`` epochs; ``held_out`` enables the reference's per-epoch
        validation eval (reference: transfer/foldingnet/
        train_foldingnet.py:129-171, transfer/atlasnet/training/
        trainer.py:83-110). -> [(epoch, loss, seconds)]."""
        pcs = torch.as_tensor(np.asarray(point_clouds, np.float32), device=self.device)
        n_batches = len(pcs) // batch_size
        stats = []
        for _ in range(epochs):
            t0 = time.time()
            loss = self._device_epoch(pcs, n_batches, batch_size)
            self.epoch += 1
            seconds = time.time() - t0
            msg = f"{tag} epoch {self.epoch:03d}: loss {loss:.6f} ({seconds:.1f}s)"
            if held_out is not None and self.epoch % val_step == 0:
                ev = self.evaluate(held_out)
                msg += f" val loss: {ev['loss']:.6f}"
                if "mid_loss" in ev:
                    msg += f" middle val loss: {ev['mid_loss']:.6f}"
            print(msg)
            if log_file is not None:
                log_file.write(msg + "\n")
            stats.append((self.epoch, loss, seconds))
        return stats

    @torch.no_grad()
    def _batches(self, pclouds, batch_size, fn):
        """fn(x on the device) per chunk of ``batch_size`` clouds, in eval mode."""
        self.model.eval()
        pcs = np.asarray(pclouds, np.float32)
        return [fn(torch.as_tensor(pcs[s:s + batch_size], device=self.device))
                for s in range(0, len(pcs), batch_size)]

    def evaluate(self, pclouds, batch_size=100):
        """Example-weighted mean clean-reconstruction loss
        (reference: transfer/foldingnet/tst_foldingnet.py:79-98)."""
        sums = self._batches(pclouds, batch_size, lambda x: float(
            chamfer_loss_per_pc(self._forward_eval(x), x).sum()))
        return {"loss": sum(sums) / len(pclouds)}

    def get_reconstructions(self, pclouds, batch_size=100):
        return np.concatenate(self._batches(
            pclouds, batch_size, lambda x: self._forward_eval(x).cpu().numpy()))

    def save(self, train_dir, epoch=None):
        epoch = self.epoch if epoch is None else epoch
        return ckpt.save_checkpoint(train_dir, epoch, self.model.state_dict(),
                                    self.optimizer.state_dict())

    def restore(self, train_dir, epoch=None):
        if epoch is None:
            epoch = ckpt.latest_epoch(train_dir)
        if epoch is None:
            raise FileNotFoundError(f"no port checkpoints under {train_dir}")
        tree = ckpt.restore_checkpoint(train_dir, epoch)
        self.model.load_state_dict(tree["state_dict"])
        if tree.get("opt_state") is not None:
            self.optimizer.load_state_dict(tree["opt_state"])
        self.epoch = int(tree["epoch"])
        return self


class AtlasNetTrainer(_TransferTrainerBase):
    """reference: transfer/atlasnet/atlasnet_ae.py + training/trainer*.py."""

    def __init__(self, number_points: int = 2500, nb_primitives: int = 1,
                 template_type: str = "SPHERE", learning_rate: float = 0.001,
                 seed: int = 0, bn_momentum: float = 0.9, device="cuda"):
        model = AtlasNet(number_points=number_points, nb_primitives=nb_primitives,
                         template_type=template_type, bn_momentum=bn_momentum)
        super().__init__(model, learning_rate, device, seed)
        self.regular_template = torch.as_tensor(
            np.stack([model.regular_template()] * nb_primitives), device=self.device)

    def _train_step(self, x: torch.Tensor, gen=None, template=None):
        """One Adam step; the train-time template is random (reference:
        atlasnet.py:55-59), drawn from ``gen`` unless given. -> the loss."""
        model = self.model
        if template is None:
            template = random_template_points(gen, model.nb_primitives,
                                              model.pts_per_primitive,
                                              model.template_dim, self.device)
        return self._step(x, lambda: model(x, template)[0])

    def _forward_eval(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, self.regular_template)[0]


class FoldingNetTrainer(_TransferTrainerBase):
    """reference: transfer/foldingnet/train_foldingnet.py + foldingnet_ae.py."""

    def __init__(self, learning_rate: float = 0.0001, seed: int = 0,
                 bn_momentum: float = 0.9, device="cuda"):
        super().__init__(FoldingNet(bn_momentum=bn_momentum), learning_rate, device, seed)

    def _full(self, x: torch.Tensor):
        nbr, cov = graph_features(x)
        recon, mid, _ = self.model(x, cov, nbr)
        return recon, mid

    def _train_step(self, x: torch.Tensor, gen=None):
        """One Adam step; -> the loss."""
        return self._step(x, lambda: self._full(x)[0])

    def _forward_eval(self, x: torch.Tensor) -> torch.Tensor:
        return self._full(x)[0]

    def evaluate(self, pclouds, batch_size=100):
        """Adds the middle-fold loss the reference reports beside the final
        one (reference: transfer/foldingnet/tst_foldingnet.py:87-98)."""
        def sums(x):
            recon, mid = self._full(x)
            return (float(chamfer_loss_per_pc(recon, x).sum()),
                    float(chamfer_loss_per_pc(mid, x).sum()))

        totals = self._batches(pclouds, batch_size, sums)
        n = len(pclouds)
        return {"loss": sum(t[0] for t in totals) / n,
                "mid_loss": sum(t[1] for t in totals) / n}


def get_transfer_ae(ae_type: str, **kwargs):
    """The ae_type switch of run_transfer (reference: transfer/run_transfer.py:97-104)."""
    if ae_type == "atlasnet":
        return AtlasNetTrainer(**kwargs)
    elif ae_type == "foldingnet":
        return FoldingNetTrainer(**kwargs)
    raise ValueError(f"unknown transfer AE type: {ae_type!r}")


ARCH_FILE = "arch.json"


def save_transfer_arch(train_dir: str, ae_type: str, **arch) -> None:
    """Record the architecture the checkpoint was trained with, so that the
    inference CLIs rebuild the matching module from the checkpoint's folder
    alone (the JAX package's arch.json, the same file)."""
    with open(osp.join(train_dir, ARCH_FILE), "w") as f:
        json.dump({"ae_type": ae_type, **arch}, f, indent=1)


def load_transfer_arch(train_dir: str) -> dict | None:
    """The architecture saved by ``save_transfer_arch``, or None."""
    path = osp.join(train_dir, ARCH_FILE)
    if not osp.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
