"""AE training and batched inference of the victim
(``geometric_adv_tpu/train/trainer.py`` ``AETrainer``; reference:
src/autoencoder.py:85-331, src/pointnet_ae.py:101-138).

A train step is forward in BN train mode, the mean per-cloud reconstruction
loss (chamfer or EMD, ``conf.loss``), backward and one Adam update with
optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square root), at
the learning rate of the optional staircase epoch schedule. An epoch is a
Python loop over batches with the data resident on the device, in the order
of an on-device permutation drawn from a generator seeded with the epoch's
number, so that a resumed run continues exactly. Inference runs in eval mode
under ``no_grad``, over host chunks of 250 clouds, each run through the
victim in blocks of ``FORWARD_BLOCK`` clouds; results come back as numpy
(float32, also for a bfloat16 victim, whose values they hold exactly).

``conf.ae_dtype`` "bfloat16" builds the victim with flax's compute dtype
(``models/layers.py``); its reconstructions are cast to float32 before the
loss, so losses and gradients past the victim stay float32.

``mesh`` (``parallel/``): under a mesh of several processes the eval-mode
batched forward and ``get_pre_symmetry_argmax`` pad each chunk to a multiple
of the mesh size, each rank runs its rows and ``gather_global`` assembles
them, as the JAX trainer does. Training shards each batch over the ranks as
the JAX trainer's sharding constraint does: every rank holds the epoch's
data, draws the one-process run's permutation and augmentations for the
whole batch and steps on its rows (``batch_sharding``), its batch norms
taking their statistics over the global batch (``set_batch_norm_mesh``); the
loss is the rank's per-cloud losses summed over the global batch size, and
one all-reduce of a flat buffer sums the gradients, with the loss beside
them, before the same Adam step on every rank. The ranks' states stay
equal, bit for bit. A batch that does not split evenly over the ranks
raises ``ValueError``. The primary alone writes checkpoints.

Training opens the spans ``train.epoch``, ``train.batch``, ``train.step``
and the step's ``train.forward``, ``train.loss``, ``train.backward``,
``train.allreduce`` (under a mesh) and ``train.optimizer``, and counts
``train.steps`` and ``train.samples`` (the global batch's rows)
(``utils/profiling.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from geometric_adv_tpu_torch.data.augment import apply_augmentations, device_augment
from geometric_adv_tpu_torch.models.layers import compute_dtype, set_batch_norm_mesh
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE, init_weights
from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
from geometric_adv_tpu_torch.ops.emd import emd_loss_per_pc
from geometric_adv_tpu_torch.parallel import (
    all_reduce_sum,
    batch_sharding,
    broadcast_object,
    gather_global,
    local_rows,
)
from geometric_adv_tpu_torch.train import checkpoint as ckpt
from geometric_adv_tpu_torch.train.config import Configuration
from geometric_adv_tpu_torch.utils.profiling import count, span

# Clouds per eval-mode forward of the victim. Each block is zero-padded to
# this size, so every GEMM of the eval forward runs on rows of one shape
# whatever the caller's batch: the CPU's GEMMs and cuBLAS choose their
# blocking, and with it each row's summation order, by shape, and the JAX
# package's batched forward is bit-identical across batch sizes on the CPU
# (geometric_adv_tpu/train/trainer.py:177-178).
FORWARD_BLOCK = 16


def reconstruction_loss_per_pc(recon, gt, loss_type: str):
    recon = recon.float()  # a bfloat16 victim's output; a no-op at float32
    if loss_type == "chamfer":
        return chamfer_loss_per_pc(recon, gt)
    elif loss_type == "emd":
        return emd_loss_per_pc(recon, gt)
    raise ValueError(f"unknown loss {loss_type!r}")


class AETrainer:
    """Owns the victim model and its Adam optimizer on ``device``; seeded
    init, then ``train`` or ``restore``. ``mesh`` shards training and the
    eval-mode batched forward over processes; a mesh of size 1 is
    ``None``."""

    def __init__(self, conf: Configuration, device, seed: int = 42, mesh=None):
        if conf.loss not in ("chamfer", "emd"):
            raise ValueError(f"unknown loss {conf.loss!r}")
        self.conf = conf
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        model = PointNetAE(
            n_points=conf.n_points,
            bneck_size=conf.bneck_size,
            encoder_filters=conf.encoder_filters,
            decoder_sizes=conf.decoder_sizes,
            bn_momentum=conf.b_norm_decay,
            dtype=compute_dtype(conf.ae_dtype),
        )
        init_weights(model, torch.Generator().manual_seed(seed))
        set_batch_norm_mesh(model, self.mesh)
        self.model = model.to(self.device).eval()
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=conf.learning_rate, betas=(0.9, 0.999),
            eps=1e-8,
        )
        self.epoch = 0

    # --- training (reference: src/autoencoder.py:196-227) -----------------
    def learning_rate(self, step: int) -> float:
        """The rate of update ``step`` (0-based): the reference's staircase
        halving keyed on the epoch with a 1e-5 floor
        (src/pointnet_ae.py:93-95), or the constant rate."""
        conf = self.conf
        if conf.exponential_decay and conf.decay_steps:
            spe = conf.steps_per_epoch or 1
            return max(conf.learning_rate
                       * 0.5 ** ((step // spe) // conf.decay_steps), 1e-5)
        return conf.learning_rate

    def _updates_done(self) -> int:
        states = self.optimizer.state.values()
        return int(next(iter(states))["step"]) if states else 0

    def _rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` (all of them without a
        mesh); ValueError where ``n`` does not split over the ranks."""
        return slice(None) if self.mesh is None else batch_sharding(self.mesh).rows(n)

    def _train_step(self, x: torch.Tensor, gt: torch.Tensor):
        """One Adam step on the batch, of which ``x`` and ``gt`` are this
        rank's rows; -> (the global batch's mean loss, this rank's recon),
        on the device. It leaves the model in train mode: its callers put it
        back in eval mode after a run of steps, so that the walk over every
        module each way comes once a run, not twice a step."""
        with span("train.step"):
            with span("train.forward"):
                if not self.model.training:
                    self.model.train()
                recon, _, _ = self.model(x)
            with span("train.loss"):
                per_pc = reconstruction_loss_per_pc(recon, gt, self.conf.loss)
                if self.mesh is None:
                    loss = per_pc.mean()
                else:
                    loss = per_pc.sum() / (len(per_pc) * self.mesh.size)
            with span("train.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            if self.mesh is not None:
                with span("train.allreduce"):
                    loss = self._all_reduce_grads(loss.detach())
            with span("train.optimizer"):
                lr = self.learning_rate(self._updates_done())
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
            return loss.detach(), recon.detach()

    def _all_reduce_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """Sum every gradient, and ``loss``, over the ranks in one
        all-reduce of a flat buffer; -> the summed loss."""
        grads = [p.grad for p in self.model.parameters()]
        flat = all_reduce_sum(
            torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)]), self.mesh)
        for g, summed in zip(grads, flat.split([g.numel() for g in grads] + [1])):
            g.copy_(summed.view_as(g))
        return flat[-1]

    def partial_fit(self, x, gt=None):
        """reference: src/autoencoder.py:105-125 -> (recon numpy, loss).
        Under a mesh every process passes the whole batch and receives the
        whole reconstruction and the global loss."""
        x = np.asarray(x, np.float32)
        gt = x if gt is None else np.asarray(gt, np.float32)
        rows = self._rows(len(x))
        loss, recon = self._train_step(torch.as_tensor(x[rows], device=self.device),
                                       torch.as_tensor(gt[rows], device=self.device))
        self.model.eval()
        count("train.steps")
        count("train.samples", len(x))
        return gather_global(recon.float()), float(loss)

    def _epoch_generator(self, epoch: int) -> torch.Generator:
        # one stream per epoch, seeded with its number (the JAX trainer keys
        # its epochs on the epoch counter too): a run resumed at any epoch
        # draws the same permutation and augmentations as an unbroken one
        return torch.Generator(device=self.device).manual_seed(epoch)

    def _device_epoch(self, data, feed, n_batches: int, conf) -> float:
        """One epoch over device-resident clouds; -> mean batch loss."""
        gen = self._epoch_generator(self.epoch + 1)
        bs = conf.batch_size
        rows = self._rows(bs)
        perm = torch.randperm(data.shape[0], generator=gen,
                              device=self.device)[: n_batches * bs]
        gauss = conf.gauss_augment
        augmented = gauss is not None or bool(conf.z_rotate)
        losses = []
        for i in range(n_batches):
            with span("train.batch"):
                idx = perm[i * bs:(i + 1) * bs]
                gt, batch = data[idx], feed[idx]
                if augmented:
                    batch = device_augment(
                        batch, gen,
                        gauss_mu=None if gauss is None else float(gauss["mu"]),
                        gauss_sigma=None if gauss is None else float(gauss["sigma"]),
                        z_rotate=bool(conf.z_rotate),
                    )
                    if not conf.is_denoising:
                        # the augmented batch is its own ground truth
                        # (reference: src/pointnet_ae.py:123-128)
                        gt = batch
                x, gt = batch[rows], gt[rows]
            losses.append(self._train_step(x, gt)[0])
        self.model.eval()
        count("train.steps", n_batches)
        count("train.samples", n_batches * bs)
        return float(torch.stack(losses).mean()) if losses else 0.0

    def _held_out_epoch(self, data, conf):
        """Forward-only pass over ``data`` in host batches
        (``_single_epoch(..., only_fw=True)``) -> (loss, seconds)."""
        n_batches = data.num_examples // conf.batch_size
        epoch_loss = 0.0
        start = time.perf_counter()
        for _ in range(n_batches):
            if conf.is_denoising:
                original, _, batch = data.next_batch(conf.batch_size)
                if batch is None:
                    batch = original
            else:
                batch, _, _ = data.next_batch(conf.batch_size)
                original = None
            batch = apply_augmentations(batch, conf).astype(np.float32)
            if original is None:
                original = batch
            epoch_loss += float(self.get_loss_per_pc(
                batch, original, batch_size=len(batch)).mean())
        epoch_loss /= max(n_batches, 1)
        if conf.loss == "emd":
            epoch_loss /= data.n_points  # reference: pointnet_ae.py:135
        return epoch_loss, time.perf_counter() - start

    def train(self, train_data, conf=None, log_file=None, held_out_data=None):
        """``conf.training_epochs`` epochs over a ``PointCloudDataSet``;
        -> [(epoch, loss, seconds)] (reference: src/autoencoder.py:196-227).
        Under a mesh every process calls it with the same data; the ranks
        take up the primary's numpy stream, from which the held-out epochs
        draw their batches and augmentations."""
        conf = conf or self.conf
        self._rows(conf.batch_size)  # raises before any collective
        if self.mesh is not None:
            np.random.set_state(broadcast_object(np.random.get_state()))
        stats = []
        n_batches = train_data.num_examples // conf.batch_size
        data = torch.as_tensor(train_data.point_clouds.astype(np.float32),
                               device=self.device)
        feed = data
        if conf.is_denoising and train_data.noisy_point_clouds is not None:
            feed = torch.as_tensor(
                train_data.noisy_point_clouds.astype(np.float32),
                device=self.device)

        for _ in range(conf.training_epochs):
            with span("train.epoch"):
                t0 = time.perf_counter()
                loss = self._device_epoch(data, feed, n_batches, conf)
                if conf.loss == "emd":
                    loss /= train_data.n_points  # reference: pointnet_ae.py:135
                duration = time.perf_counter() - t0
                self.epoch += 1
                epoch = self.epoch
                stats.append((epoch, loss, duration))

                if epoch % conf.loss_display_step == 0:
                    print(f"Epoch: {epoch:04d} training time (minutes)= "
                          f"{duration / 60.0:.4f} loss= {loss:.9f}")
                    if log_file is not None:
                        log_file.write(
                            "%04d\t%.9f\t%.4f\n" % (epoch, loss, duration / 60.0)
                        )

            if conf.saver_step is not None and (
                epoch % conf.saver_step == 0 or epoch == 1
            ):
                self.save(conf.train_dir, epoch)

            if (
                held_out_data is not None
                and conf.held_out_step is not None
                and epoch % conf.held_out_step == 0
            ):
                ho_loss, ho_dur = self._held_out_epoch(held_out_data, conf)
                print(f"Held Out Data : forward time (minutes)= "
                      f"{ho_dur / 60.0:.4f} loss= {ho_loss:.9f}")
                if log_file is not None:
                    log_file.write(
                        "On Held_Out: %04d\t%.9f\t%.4f\n"
                        % (epoch, ho_loss, ho_dur / 60.0)
                    )
        return stats

    # --- checkpointing ----------------------------------------------------
    def save(self, train_dir, epoch=None):
        """Under a mesh every rank calls it; the primary writes."""
        epoch = self.epoch if epoch is None else epoch
        return ckpt.save_checkpoint(train_dir, epoch, self.model.state_dict(),
                                    self.optimizer.state_dict(), mesh=self.mesh)

    def restore(self, train_dir, epoch=None):
        """Weights, BN statistics, epoch and -- where the checkpoint has
        them -- the Adam moments and step, so that a resumed run continues
        exactly (reference: tf.train.Saver restores slot variables)."""
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

    def set_adam_state(self, per_param: dict) -> None:
        """Install Adam state keyed by parameter name (the layout of
        ``models.bridge.adam_state_from_optax``)."""
        for name, p in self.model.named_parameters():
            self.optimizer.state[p] = {
                k: v.to(p.device) if k != "step" else v
                for k, v in per_param[name].items()
            }

    # --- inference --------------------------------------------------------
    def _block_outputs(self, xb, gb, outputs):
        """The eval forward of at most FORWARD_BLOCK clouds ``xb`` (ground
        truth ``gb`` for the loss) on the device, zero-padded to
        FORWARD_BLOCK; -> the requested outputs of the real rows."""
        k = len(xb)

        def padded(t):
            if k == FORWARD_BLOCK:
                return t
            return torch.cat([t, t.new_zeros((FORWARD_BLOCK - k,) + t.shape[1:])])

        pre = self.model.encoder(padded(xb))
        res = {"pre": pre}
        if "pre_argmax" in outputs:
            res["pre_argmax"] = pre.argmax(dim=-2).to(torch.int32)
            res["pre_max"] = pre.amax(dim=-2)
        if {"recon", "z", "loss"} & set(outputs):
            res["z"] = pre.amax(dim=-2)  # as PointNetAE.forward
            res["recon"] = self.model.decode(res["z"])
        if "loss" in outputs:
            res["loss"] = reconstruction_loss_per_pc(res["recon"], padded(gb),
                                                     self.conf.loss)
        return {name: res[name][:k] if res[name].dtype == torch.int32
                else res[name][:k].float() for name in outputs}

    @torch.no_grad()
    def _batched_forward(self, pclouds, gt=None, batch_size=250,
                         outputs=("recon", "z", "pre", "loss")):
        """Chunked eval-mode inference; only the requested ``outputs``
        (among them "pre_argmax" and "pre_max", the pre-symmetry features'
        per-channel argmax and max over the points) are copied to the host.

        Each chunk of ``batch_size`` clouds runs in blocks of FORWARD_BLOCK
        clouds, so a cloud's results do not depend on the chunk or the batch
        it sits in. Under a mesh the chunk is padded to a multiple of its
        size (the last cloud repeated), each rank runs its rows and
        ``gather_global`` assembles the chunk."""
        self.model.eval()
        gt = pclouds if gt is None else gt
        outs = {k: [] for k in outputs}
        for s in range(0, len(pclouds), batch_size):
            x, n = local_rows(pclouds[s : s + batch_size], self.mesh, self.device)
            g = (local_rows(gt[s : s + batch_size], self.mesh, self.device)[0]
                 if "loss" in outputs else None)
            blocks = [self._block_outputs(
                x[b : b + FORWARD_BLOCK],
                None if g is None else g[b : b + FORWARD_BLOCK], outputs)
                for b in range(0, len(x), FORWARD_BLOCK)]
            picked = gather_global(
                {k: torch.cat([blk[k] for blk in blocks]) for k in outputs})
            for k in outputs:
                outs[k].append(picked[k][:n])
        return {k: np.concatenate(v) for k, v in outs.items()}

    def reconstruct(self, x, gt=None, compute_loss=True):
        """(reconstructions, mean loss or None) of ``x`` in one batch."""
        out = self._batched_forward(
            x, gt, batch_size=len(x), outputs=("recon", "loss")
        )
        loss = float(out["loss"].mean()) if compute_loss else None
        return out["recon"], loss

    def get_reconstructions(self, pclouds, batch_size=250):
        return self._batched_forward(
            pclouds, batch_size=batch_size, outputs=("recon",)
        )["recon"]

    def get_latent_vectors(self, pclouds, batch_size=250):
        return self._batched_forward(
            pclouds, batch_size=batch_size, outputs=("z",)
        )["z"]

    def get_pre_symmetry_data(self, pclouds, batch_size=250):
        return self._batched_forward(
            pclouds, batch_size=batch_size, outputs=("pre",)
        )["pre"]

    def get_pre_symmetry_argmax(self, pclouds, batch_size=250):
        """Per-channel (argmax [N, bneck] int32, max [N, bneck]) over the
        points of the pre-symmetry features, reduced on the device so that
        only [N, bneck] crosses to the host, not the [N, n, bneck] map.
        ``torch.argmax`` takes the first maximal index, as ``jnp.argmax``."""
        out = self._batched_forward(pclouds, batch_size=batch_size,
                                    outputs=("pre_argmax", "pre_max"))
        return out["pre_argmax"], out["pre_max"]

    def get_loss_per_pc(self, feed_data, orig_data=None, batch_size=250):
        return self._batched_forward(
            feed_data, orig_data, batch_size=batch_size, outputs=("loss",)
        )["loss"]

    def transform(self, x):
        return self.get_latent_vectors(x, batch_size=len(x))

    @torch.no_grad()
    def decode(self, z):
        self.model.eval()
        z = torch.as_tensor(np.atleast_2d(np.asarray(z, np.float32)),
                            device=self.device)
        return self.model.decode(z).float().cpu().numpy()

    def evaluate(self, in_data, conf=None, ret_pre_augmentation=False):
        """Full-set reconstruction and mean loss over a ``PointCloudDataSet``
        (reference: src/autoencoder.py:229-261) -> (recon, loss, feed, ids,
        original[, the denoising feed before augmentation])."""
        conf = conf or self.conf
        pre_aug = None
        if self.conf.is_denoising:
            original, ids, feed = in_data.full_epoch_data(shuffle=False)
            if feed is None:
                feed = original
            if ret_pre_augmentation:
                pre_aug = feed.copy()
            feed = apply_augmentations(feed, conf)
        else:
            original, ids, _ = in_data.full_epoch_data(shuffle=False)
            feed = apply_augmentations(original, conf)
        # the loss's ground truth: the clean original when denoising, else
        # the (possibly augmented) feed itself (reference:
        # src/autoencoder.py:247-251)
        gt = original if self.conf.is_denoising else feed
        out = self._batched_forward(
            feed.astype(np.float32), gt.astype(np.float32),
            batch_size=conf.batch_size, outputs=("recon", "loss"),
        )
        data_loss = float(out["loss"].mean())
        print("evaluation loss=", "{:.9f}".format(data_loss))
        if pre_aug is not None:
            return out["recon"], data_loss, feed, ids, original, pre_aug
        return out["recon"], data_loss, feed, ids, original

    @torch.no_grad()
    def embedding_at_layer(self, pclouds, layer_path=None, batch_size=50):
        """Activations at an intermediate layer (reference:
        src/autoencoder.py:263-294). ``layer_path`` is the JAX package's
        module path, e.g. ``("decoder", "fc_0", "__call__")``: the output of
        that module's forward, taken by a forward hook during a full eval
        forward; None gives the latent codes."""
        if layer_path is None:
            return self.get_latent_vectors(pclouds, batch_size=batch_size)
        *names, method = layer_path
        if method != "__call__":
            raise ValueError(f"layer_path {layer_path!r}: only a module's "
                             "__call__ output can be taken")
        module = self.model.get_submodule(".".join(names))
        captured = []
        hook = module.register_forward_hook(
            lambda mod, args, out: captured.append(
                out[0] if isinstance(out, tuple) else out))
        self.model.eval()
        outs = []
        try:
            pcs = np.asarray(pclouds, np.float32)
            for s in range(0, len(pcs), batch_size):
                captured.clear()
                self.model(torch.as_tensor(pcs[s:s + batch_size],
                                           device=self.device))
                outs.append(captured[0].float().cpu().numpy())
        finally:
            hook.remove()
        return np.concatenate(outs)

    def interpolate(self, x, y, steps):
        """reference: src/autoencoder.py:178-189."""
        z = self.transform(np.stack([x, y]))
        alphas = np.linspace(0, 1, steps + 2)[:, None]
        all_z = alphas * z[1] + (1.0 - alphas) * z[0]
        return self.decode(all_z.astype(np.float32))


def build_trainer_from_checkpoint(conf: Configuration, train_dir: str,
                                  epoch: int | None = None,
                                  device="cuda", mesh=None) -> AETrainer:
    return AETrainer(conf, device, mesh=mesh).restore(train_dir, epoch)
