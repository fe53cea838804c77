"""The victim's training as ``train_ae`` runs it: ``AETrainer.train`` over
device-resident clouds, epochs back to back.

Set-up builds the trainer, loads the benchmark's seeded weights into its
model, makes the traffic's clouds, and drives the trainer through its first
three steps with ``train`` on three one-batch datasets of distinct rows
(the start of the check, ``core/train_check.py``; they also warm the step's
shapes up). A window call is ``train`` over the whole dataset for
``epochs_per_call`` epochs on the same trainer, with a ``train_check.Tap``
on it: the call's rate counts the rows its optimizer steps stepped over,
and the check reads, besides the start:

- ``step_grad_gap``, ``step_update_gap``: ``check_steps_per_call`` steps of
  every call, drawn from the seed, each taken again by the reference from
  the program's state before it, on the batch it should have fed;
- ``feed_gap``: the steps of the window whose clouds are not the ones the
  trainer's epoch order puts there (a batch left out, repeated or out of
  its place), and the steps too many or too few; 0 where every step fed
  its batch.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.core import train_check
from h100_bench.core.clouds import generator, make_clouds
from h100_bench.core.precision import pinned
from h100_bench.core.weights import layout, seeded_weights
from h100_bench.reference import pointnet_ae as ref_ae
from h100_bench.reference.chamfer import chamfer_per_pc
from h100_bench.reference.training import adam_steps

UNIT = "samples"
START_STEPS = 3


class State:
    pass


def epoch_order(epoch: int, rows: int, device) -> torch.Tensor:
    """The order the trainer's epoch ``epoch`` (1-based, counted over the
    trainer's life) visits ``rows`` clouds in: a permutation from a
    generator on the device seeded with the epoch's number."""
    gen = torch.Generator(device=device).manual_seed(epoch)
    return torch.randperm(rows, generator=gen, device=device)


def setup(cell):
    from geometric_adv_tpu_torch.data.datasets import PointCloudDataSet
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    n, bs = cfg["n_points"], cfg["batch_size"]
    s = State()
    s.cell = cell
    conf = Configuration(n_input=[n, 3], loss=cfg["loss"], bneck_size=cfg["bneck_size"],
                         encoder_filters=cfg["encoder_filters"],
                         decoder_sizes=cfg["decoder_sizes"],
                         b_norm_decay=cfg["b_norm_decay"], batch_size=bs,
                         learning_rate=cfg["learning_rate"], training_epochs=1,
                         saver_step=None, held_out_step=None)
    trainer = AETrainer(conf, dev)
    gen = generator(cell.seed, dev)
    s.w = seeded_weights(layout(trainer.model), gen, dev)
    trainer.model.load_state_dict(s.w)
    s.clouds, _ = make_clouds(gen, tr["train_clouds"], n, dev)
    host = s.clouds.cpu().numpy()
    s.readings = train_check.Readings()
    s.batches = []
    for k in range(START_STEPS):
        stats = trainer.train(PointCloudDataSet(host[k * bs:(k + 1) * bs], init_shuffle=False))
        s.readings.after_step(trainer.model, trainer.optimizer, stats[0][1])
        s.batches.append((s.clouds[k * bs:(k + 1) * bs][epoch_order(k + 1, bs, dev)],))
    s.readings.after_three(trainer.model, s.w)
    conf.training_epochs = tr["epochs_per_call"]
    s.dataset = PointCloudDataSet(host, init_shuffle=False)
    s.trainer, s.conf = trainer, conf
    s.epochs = START_STEPS  # the trainer's epochs so far: one a start step
    s.steps_per_epoch = len(host) // bs
    s.kept = []  # per window call: (its first epoch, rows fed, sampled steps)
    s.rng = np.random.default_rng([cell.seed % (1 << 63), 11])
    return s


def call(s) -> float:
    steps = s.steps_per_epoch * s.conf.training_epochs
    sample = s.rng.choice(steps, min(s.cell.traffic["check_steps_per_call"], steps),
                          replace=False)
    tap = train_check.Tap(s.trainer.model, s.trainer.optimizer, sample)
    try:
        s.trainer.train(s.dataset, s.conf)
    finally:
        tap.close()
    s.kept.append((s.epochs + 1, tap.fed, {int(k): tap.taken.get(int(k), {}) for k in sample}))
    s.epochs += s.conf.training_epochs
    return float(tap.rows)


def traced_call(s) -> float:
    """A call under the profiler: nothing tapped, nothing kept."""
    s.trainer.train(s.dataset, s.conf)
    s.epochs += s.conf.training_epochs
    return 0.0


def trace_module(s):
    return s.trainer.model.encoder


def shapes(s) -> dict:
    n, bs = s.cell.config["n_points"], s.cell.config["batch_size"]
    return {"chamfer": [bs, n, n], "units_per_step": bs}


def loss_fn(s, alter=None):
    n = s.cell.config["n_points"]

    def fn(w, x):
        recon = ref_ae.decode(w, ref_ae.encode(w, x, train=True), n)
        if alter is not None:
            recon = alter(recon)
        return chamfer_per_pc(recon, x).mean()

    return fn


def _call_batches(s, first_epoch: int) -> torch.Tensor:
    """[steps, batch] rows of the clouds that a window call beginning at
    the trainer's epoch ``first_epoch`` should feed, in step order."""
    rows, bs, k = len(s.clouds), s.cell.config["batch_size"], s.steps_per_epoch
    return torch.cat([epoch_order(e, rows, s.clouds.device)[:k * bs].view(k, bs)
                      for e in range(first_epoch, first_epoch + s.conf.training_epochs)])


def _window(s) -> dict:
    """The window's numbers: ``feed_gap`` and the sampled steps' gaps."""
    first = s.clouds[:, 0, 0]
    feed_gap, steps = 0, []
    for first_epoch, fed, sampled in s.kept:
        want = _call_batches(s, first_epoch)
        expected = first[want].sort(dim=1).values
        feed_gap += abs(len(fed) - len(want))
        feed_gap += sum(not (got.shape == row.shape and torch.equal(got.sort().values, row))
                        for got, row in zip(fed, expected))
        steps += [((s.clouds[want[j]],), taken) for j, taken in sampled.items()]
    out = train_check.step_gaps(steps, s.w, loss_fn(s), s.cell.config["learning_rate"])
    out["feed_gap"] = float(feed_gap)
    return out


def _free_program(s):
    s.names = [k for k, _ in s.trainer.model.named_parameters()]
    del s.trainer, s.dataset
    if s.cell.device.type == "cuda":
        torch.cuda.empty_cache()


def check(s) -> list:
    if hasattr(s, "trainer"):
        _free_program(s)
    with pinned(False):
        start = adam_steps(s.w, s.names, s.batches, loss_fn(s), s.cell.config["learning_rate"])
    return train_check.compare(s.readings, start[:3], s.w, _window(s),
                               s.cell.workload["limits"], s.cell.info)


def control(s, kind: str) -> list:
    """The checks with the reference in the program's place: "tf32" (TF32
    on), or the planted faults "half_batch" and "altered" (``train_check``),
    at the start and at the sampled steps of one window call, taken from
    the program's state before each."""
    call(s)
    s.readings = train_check.stand_in(kind, s, loss_fn)
    first_epoch, _fed, sampled = s.kept[-1]
    want = _call_batches(s, first_epoch)
    for j, taken in sampled.items():
        taken["after"] = train_check.stand_in_step(kind, s, loss_fn, (s.clouds[want[j]],),
                                                   taken["before"])
    return check(s)
