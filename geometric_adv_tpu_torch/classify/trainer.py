"""PointNet classifier training and inference
(``geometric_adv_tpu/classify/trainer.py``; reference:
classifier/train_classifier.py, classifier/pointnet_classifier.py:54-73).

A train step is forward in BN train mode with dropout, the loss
``classifier_loss`` (CE + the feature transform's orthogonality term),
backward and one Adam update with optax's defaults. Before each step the BN
momentum of every batch norm, T-Nets included, is set from
``bn_momentum_schedule`` (0.5 -> 0.99 on the example count) and the learning
rate from the staircase schedule (x0.7 per 200k examples, floor 1e-5), both
at the count of updates done before the step, as optax counts. Both are
computed in float32, as the JAX package traces them.

An epoch runs over device-resident clouds in the order of an on-device
permutation, each batch jittered by N(0, 0.01) clipped at +-0.05
(reference: classifier/provider.py:66-77) and given fresh dropout masks, all
drawn from one generator seeded with the epoch's number and ``train``'s
seed. Inference runs in
eval mode in batches of 250 clouds and returns int8 argmax labels, the first
maximum on ties.

``mesh`` (``parallel/``), as the JAX trainer's: ``classify`` pads each batch
to a multiple of the mesh size, each rank runs its rows and
``gather_global`` assembles them; ``train`` runs every step whole on every
rank (the JAX trainer replicates the classifier's state and does not shard
its epoch), so the ranks hold the same weights; the primary alone writes
checkpoints.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from geometric_adv_tpu_torch.models.pointnet_cls import (
    PointNetClassifier,
    classifier_loss,
    draw_dropout_masks,
    init_classifier_weights,
    set_bn_momentum,
)
from geometric_adv_tpu_torch.parallel import gather_global, local_rows
from geometric_adv_tpu_torch.train import checkpoint as ckpt

JITTER_SIGMA, JITTER_CLIP = 0.01, 0.05  # reference: classifier/provider.py:66-77


def jitter_point_cloud(batch, sigma=0.01, clip=0.05, rng=None):
    """reference: classifier/provider.py:66-77."""
    rng = rng or np.random
    return batch + np.clip(
        sigma * rng.standard_normal(batch.shape).astype(batch.dtype),
        -clip, clip,
    )


def bn_momentum_schedule(step, batch_size, decay_step=200000.0, init_decay=0.5,
                         decay_decay_rate=0.5, clip=0.99) -> float:
    """min(0.99, 1 - 0.5 * 0.5^floor(step * bs / decay_step)), in float32
    (reference: classifier/train_classifier.py:80-83, 104-110). TF's
    ``decay`` and the port's BN ``momentum`` share the convention
    ra = m * ra + (1 - m) * batch_stat."""
    f32 = np.float32
    examples = f32(step) * f32(batch_size)
    momentum = f32(init_decay) * f32(decay_decay_rate) ** np.floor(
        examples / f32(decay_step))
    return float(np.minimum(f32(clip), f32(1.0) - momentum))


class ClassifierTrainer:
    """Owns the classifier and its Adam optimizer on ``device``; seeded init,
    then ``train`` or ``restore``. ``mesh`` shards ``classify`` over
    processes; a mesh of size 1 is ``None``."""

    def __init__(self, num_classes: int = 13, batch_size: int = 32,
                 base_lr: float = 0.001, decay_step: int = 200000,
                 decay_rate: float = 0.7, seed: int = 0, bn_momentum: float = 0.9,
                 device="cuda", mesh=None):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.base_lr = base_lr
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.device = torch.device(device)
        model = PointNetClassifier(num_classes=num_classes, bn_momentum=bn_momentum)
        init_classifier_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=base_lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.epoch = 0

    def learning_rate(self, step: int) -> float:
        """The rate of update ``step`` (0-based), in float32: base_lr *
        decay_rate^((step * bs) // decay_step), at least 1e-5 (reference:
        classifier/train_classifier.py:92-100, "CLIP THE LEARNING RATE")."""
        f32 = np.float32
        lr = f32(self.base_lr) * f32(self.decay_rate) ** np.int32(
            (step * self.batch_size) // self.decay_step)
        return float(np.maximum(lr, f32(1e-5)))

    def bn_momentum(self, step: int) -> float:
        return bn_momentum_schedule(step, self.batch_size, float(self.decay_step))

    def _updates_done(self) -> int:
        states = self.optimizer.state.values()
        return int(next(iter(states))["step"]) if states else 0

    def _train_step(self, x: torch.Tensor, labels: torch.Tensor, dropout_masks):
        """One Adam step on an already jittered batch with the given dropout
        keep masks ([b, 512], [b, 256]); -> (loss, accuracy), on the device."""
        step = self._updates_done()
        set_bn_momentum(self.model, self.bn_momentum(step))
        self.model.train()
        logits, transform = self.model(x, dropout_masks=dropout_masks)
        loss = classifier_loss(logits, labels, transform)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate(step)
        self.optimizer.step()
        self.model.eval()
        acc = (logits.detach().argmax(dim=-1) == labels).float().mean()
        return loss.detach(), acc

    def _device_epoch(self, pcs: torch.Tensor, labels: torch.Tensor,
                      n_batches: int, seed: int = 0):
        """One epoch: permutation, jitter and dropout from one generator
        seeded with the epoch's number plus ``seed`` times an odd constant
        (seed 0: the epoch's number alone; the CPU generator keeps only a
        seed's low 32 bits); -> (mean loss, mean accuracy)."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self.epoch + 1 + seed * 0x9E3779B1) % 2**63)
        bs = self.batch_size
        perm = torch.randperm(pcs.shape[0], generator=gen,
                              device=self.device)[: n_batches * bs]
        losses, accs = [], []
        for i in range(n_batches):
            idx = perm[i * bs:(i + 1) * bs]
            x = pcs[idx]
            noise = torch.randn(x.shape, generator=gen, device=self.device)
            x = x + torch.clamp(JITTER_SIGMA * noise, -JITTER_CLIP, JITTER_CLIP)
            masks = draw_dropout_masks(bs, gen, self.device)
            loss, acc = self._train_step(x, labels[idx], masks)
            losses.append(loss)
            accs.append(acc)
        if not losses:
            return 0.0, 0.0
        return float(torch.stack(losses).mean()), float(torch.stack(accs).mean())

    def train(self, point_clouds, labels, epochs=150, log_file=None, seed=0,
              eval_data=None):
        """The epoch loop (reference: classifier/train_classifier.py:227-262);
        -> [(epoch, loss, accuracy, seconds)]. ``seed`` picks the epochs'
        random streams (``_device_epoch``), as the JAX trainer's key does;
        with ``eval_data`` = (clouds, labels) the accuracy on it is printed
        every 10 epochs."""
        pcs = torch.as_tensor(np.asarray(point_clouds, np.float32), device=self.device)
        lbl = torch.as_tensor(np.asarray(labels, np.int64), device=self.device)
        n_batches = len(pcs) // self.batch_size
        stats = []
        for _ in range(epochs):
            t0 = time.time()
            loss, acc = self._device_epoch(pcs, lbl, n_batches, seed)
            self.epoch += 1
            seconds = time.time() - t0
            msg = (f"Classifier epoch {self.epoch:03d}: loss {loss:.4f} acc "
                   f"{acc:.4f} ({seconds:.1f}s)")
            print(msg)
            if log_file is not None:
                log_file.write(msg + "\n")
            stats.append((self.epoch, loss, acc, seconds))
            if eval_data is not None and self.epoch % 10 == 0:
                ex, ey = eval_data
                pred = self.classify(ex)
                print(f"  eval acc: {float((pred == ey).mean()):.4f}")
        return stats

    @torch.no_grad()
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self.model(x)[0]

    def classify(self, point_clouds, batch_size=None) -> np.ndarray:
        """Predicted labels, int8 (reference: pointnet_classifier.py:54-73),
        in batches of 250 by default; under a mesh each rank labels its rows
        of each batch, padded to a multiple of the mesh size."""
        batch_size = batch_size or 250
        pcs = np.asarray(point_clouds, np.float32)
        preds = []
        for s in range(0, len(pcs), batch_size):
            xb, n = local_rows(pcs[s:s + batch_size], self.mesh, self.device)
            preds.append(gather_global(self._logits(xb).argmax(dim=-1))[:n])
        return np.concatenate(preds).astype(np.int8)

    def save(self, train_dir, epoch=None):
        """Under a mesh every rank calls it; the primary writes."""
        epoch = self.epoch if epoch is None else epoch
        return ckpt.save_checkpoint(train_dir, epoch, self.model.state_dict(),
                                    self.optimizer.state_dict(), mesh=self.mesh)

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
