"""Training under a mesh (the port's ``parallel/`` over torch.distributed,
gloo on the CPU) against one process and against the JAX package.

- units: the device backend chosen from the layout (NCCL where every rank
  has a card of its own, gloo where two share one or the ranks run on the
  CPU); the collectives are the identity without a mesh or with one
  process, and a one-process mesh leaves the batch norm's bits as they
  were; a batch that does not split over the ranks raises ValueError.
- over 2 and 4 spawned ranks, each started as the CLIs start (the ``GAT_``
  variables): the differentiable all-reduce's forward and backward against
  autograd on the concatenated batch (rtol 1e-5 / atol 1e-6); the batch norm
  in train mode against one process on the whole batch (outputs, input and
  parameter gradients, running statistics at rtol 1e-5 / atol 1e-6); one
  ``partial_fit`` from bridged weights against the JAX package's
  single-process ``_jit_train_step`` at tests/test_trainer.py:69-111's bars
  (loss rtol 1e-5, reconstructions atol 1e-4, parameters within 1e-4 but
  the encoder's Dense biases, which the batch norm makes degenerate);
  ``train`` for 2 epochs with ``gauss_augment``, ``z_rotate``, a denoising
  feed and a held-out set that wraps, against the port in one process
  (per-epoch and held-out losses at rtol 1e-5), every rank's parameters,
  statistics and Adam moments bit-equal, the checkpoints written once;
  ``ClassifierTrainer(mesh=)``: ``classify`` over a chunk that needs padding
  equal to one process, the replicated training bit-equal on every rank;
  ``train_ae`` over the 4 ranks against one process.
- ``train_ae`` as 2 CLI processes started with the ``GAT_`` variables
  against one process, at tests/test_distributed.py:186's and
  :215-223's bars, its files written by the primary alone.

The ranks are spawned by tests/test_torch_parallel.py's ``spawn`` (a
rendezvous port of their own and a timeout); each world size runs every
case in one spawn, shared by this module's tests.
"""

import io
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_parallel import REPO, THREADS, TIMEOUT, free_port, join_group, spawn

from geometric_adv_tpu_torch import parallel
from geometric_adv_tpu_torch.parallel import Mesh

TINY = dict(n_input=[64, 3], bneck_size=16, encoder_filters=[16, 32, 16],
            decoder_sizes=[32, 32], batch_size=8, learning_rate=0.005)
TRAIN = dict(TINY, training_epochs=2, gauss_augment={"mu": 0.0, "sigma": 0.01},
             z_rotate=True, is_denoising=True, saver_step=1, held_out_step=1)
TOL = dict(rtol=1e-5, atol=1e-6)
NUMPY_SEED = 100  # each rank seeds numpy's stream with NUMPY_SEED + rank


def tiny_clouds(n, n_points=64, seed=0):
    from geometric_adv_tpu_torch.data.synthetic import sample_shape

    rng = np.random.RandomState(seed)
    names = ["sphere", "cube", "torus"]
    return np.stack([sample_shape(names[i % 3], n_points, rng)
                     for i in range(n)]).astype(np.float32)


def make_inputs(d):
    """Every case's inputs, made once from seeds and read by every rank."""
    rng = np.random.RandomState(0)
    clouds = tiny_clouds(24)
    val = tiny_clouds(10, seed=1)
    np.savez(
        osp.join(d, "inputs.npz"),
        x=rng.randn(12, 5).astype(np.float32), gx=rng.randn(12, 5).astype(np.float32),
        bn_x=(rng.randn(8, 16, 6) * 2 + 1).astype(np.float32),
        bn_gy=rng.randn(8, 16, 6).astype(np.float32),
        bn_scale=(1 + 0.1 * rng.randn(6)).astype(np.float32),
        bn_bias=(0.1 * rng.randn(6)).astype(np.float32),
        bn_mean=(0.1 * rng.randn(6)).astype(np.float32),
        bn_var=(0.5 + rng.rand(6)).astype(np.float32),
        step=clouds[:8], clouds=clouds,
        noisy=(clouds + 0.02 * rng.randn(*clouds.shape)).astype(np.float32),
        val=val, val_noisy=(val + 0.02 * rng.randn(*val.shape)).astype(np.float32),
        cls_x=tiny_clouds(8, 32, seed=2), cls_y=np.arange(8) % 3,
        probe=tiny_clouds(7, 32, seed=3))


def batch_norm(inp):
    from geometric_adv_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(6, momentum=0.9).train()
    with torch.no_grad():
        for name, key in (("weight", "bn_scale"), ("bias", "bn_bias"),
                          ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            getattr(bn, name).copy_(torch.from_numpy(inp[key]))
    return bn


def run_batch_norm(bn, x, gy):
    """-> (y, dx, dweight, dbias, running mean, running var) of one
    train-mode forward and backward of sum(y * gy)."""
    x = torch.from_numpy(x).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(gy)).sum().backward()
    return (y.detach().numpy(), x.grad.numpy(), bn.weight.grad, bn.bias.grad,
            bn.running_mean.numpy().copy(), bn.running_var.numpy().copy())


def run_all_reduce(x, gx, mesh):
    """sum(x * s * gx) with s = every row's x^2 summed over the mesh; ->
    (x * s, dx, s)."""
    x = torch.from_numpy(x).requires_grad_(True)
    s = parallel.differentiable_all_reduce_sum((x * x).sum(0), mesh)
    out = x * s
    (out * torch.from_numpy(gx)).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), s.detach().numpy()


def trainer_state(trainer):
    """Every tensor of the trainer: parameters, statistics, Adam moments."""
    state = {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()}
    for name, p in trainer.model.named_parameters():
        for k, v in trainer.optimizer.state[p].items():
            state[f"adam.{name}.{k}"] = v.numpy().copy()
    return state


def datasets(inp):
    from geometric_adv_tpu_torch.data.datasets import PointCloudDataSet

    return (PointCloudDataSet(inp["clouds"], noise=inp["noisy"], init_shuffle=False),
            PointCloudDataSet(inp["val"], noise=inp["val_noisy"], init_shuffle=False))


def train_run(inp, train_dir, mesh, rank):
    """``train`` of TRAIN from seed 42; -> (stats, the log's lines, trainer)."""
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    trainer = AETrainer(Configuration(**TRAIN, train_dir=train_dir), "cpu", mesh=mesh)
    train, val = datasets(inp)
    np.random.seed(NUMPY_SEED + rank)
    log = io.StringIO()
    stats = trainer.train(train, log_file=log, held_out_data=val)
    return stats, log.getvalue().splitlines(), trainer


def cls_trainer(mesh):
    from geometric_adv_tpu_torch.classify.trainer import ClassifierTrainer

    return ClassifierTrainer(num_classes=3, batch_size=4, device="cpu", mesh=mesh)


def train_ae_argv(d, folder):
    return ["--project_dir", d, "--device", "cpu", "--data_folder", "data/tiny",
            "--n_points", "32", "--bneck_size", "8", "--batch_size", "8",
            "--training_epochs", "2", "--train_folder", folder]


def _mesh_worker(rank, world, port, d):
    """Every case over ``world`` ranks; writes rank<r>.npz under d/w<world>."""
    from geometric_adv_tpu_torch.cli import train_ae
    from geometric_adv_tpu_torch.models.layers import set_batch_norm_mesh
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    mesh = join_group(rank, world, port)
    inp = np.load(osp.join(d, "inputs.npz"))
    out_dir = osp.join(d, f"w{world}")
    out = {}
    backend, reason = parallel.device_backend()
    out["backend"] = np.array([backend, reason])

    rows = parallel.batch_sharding(mesh).rows(len(inp["x"]))
    out["ar_out"], out["ar_dx"], out["ar_s"] = run_all_reduce(
        inp["x"][rows], inp["gx"][rows], mesh)
    out["ar_plain"] = parallel.all_reduce_sum(torch.full((3,), rank + 1.0), mesh).numpy()

    bn = batch_norm(inp)
    set_batch_norm_mesh(bn, mesh)
    rows = parallel.batch_sharding(mesh).rows(len(inp["bn_x"]))
    y, dx, dw, db, rm, rv = run_batch_norm(bn, inp["bn_x"][rows], inp["bn_gy"][rows])
    out.update(bn_y=y, bn_dx=dx, bn_rm=rm, bn_rv=rv,
               bn_dw=parallel.all_reduce_sum(dw, mesh).numpy(),
               bn_db=parallel.all_reduce_sum(db, mesh).numpy())

    step = AETrainer(Configuration(**TINY), "cpu", mesh=mesh)
    step.model.load_state_dict(torch.load(osp.join(d, "jax_victim.pt")))
    out["pf_recon"], loss = step.partial_fit(inp["step"])
    out["pf_loss"] = np.float32(loss)
    out.update({"pf." + k: v for k, v in trainer_state(step).items()})

    stats, lines, trainer = train_run(inp, osp.join(out_dir, "train"), mesh, rank)
    out["tr_losses"] = np.array([s[1] for s in stats])
    out["tr_log"] = np.array(lines)
    out.update({"tr." + k: v for k, v in trainer_state(trainer).items()})

    cls = cls_trainer(mesh)
    cls.train(inp["cls_x"], inp["cls_y"], epochs=1)
    cls.save(osp.join(out_dir, "cls"))
    out["cls_labels"] = cls.classify(inp["probe"], batch_size=5)
    out.update({"cls." + k: v.numpy() for k, v in cls.model.state_dict().items()})

    if world == 4:
        out["ae_losses"] = np.array(
            [s[1] for s in train_ae.main(train_ae_argv(d, "log/ae_4proc"))])
    parallel.barrier()
    np.savez(osp.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """The inputs, the JAX victim's bridged weights, and train_ae's data."""
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir

    d = tmp_path_factory.mktemp("train_mesh")
    make_inputs(str(d))
    _, sd = jax_step()
    torch.save(sd, d / "jax_victim.pt")
    make_shapenet_like_dir(str(d / "data/tiny"), ["sphere", "cube"], 20, 32)
    return d


def jax_step():
    """The JAX package's trainer (seed 42) and its weights bridged."""
    import jax

    from geometric_adv_tpu.train import AETrainer as JaxTrainer
    from geometric_adv_tpu.train import Configuration as JaxConfiguration
    from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax

    jt = JaxTrainer(JaxConfiguration(**TINY))
    return jt, state_dict_from_flax(jax.tree.map(np.asarray, jt.state.params),
                                    jax.tree.map(np.asarray, jt.state.batch_stats))


@pytest.fixture(scope="module")
def runs(project):
    """world -> (world, every rank's results), spawning each world once."""
    done = {}

    def run(world):
        if world not in done:
            spawn(_mesh_worker, world, str(project))
            done[world] = (world, [dict(np.load(project / f"w{world}" / f"rank{r}.npz"))
                                   for r in range(world)])
        return done[world]

    return run


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, runs):
    return runs(request.param)


@pytest.fixture(scope="module")
def inputs(project):
    return dict(np.load(project / "inputs.npz"))


def rank_rows(world, rank, n):
    return parallel.batch_sharding(Mesh(world, rank, torch.device("cpu"))).rows(n)


# --- units -------------------------------------------------------------------
@pytest.mark.parametrize("layout,backend,reason", [
    ([("a", 0), ("a", 0)], "gloo", "ranks 0,1 share cuda:0 on a"),
    ([("a", 0), ("a", 1), ("a", 1), ("a", 2)], "gloo", "ranks 1,2 share cuda:1 on a"),
    ([("a", 0), ("a", 1)], "nccl", "each of the 2 ranks has a card of its own"),
    ([("a", 0), ("b", 0)], "nccl", "each of the 2 ranks has a card of its own"),
    ([("a", -1), ("a", -1)], "gloo", "the ranks run on the CPU"),
])
def test_device_backend_follows_the_layout(layout, backend, reason):
    assert parallel.backend_for_layout(layout) == (backend, reason)


def test_collectives_without_a_mesh_are_the_identity():
    """No mesh, or a mesh of one process: both all-reduces return their
    input, the batch norm keeps its one-process bits, and no backend is
    chosen while no group is up."""
    from geometric_adv_tpu_torch.models.layers import set_batch_norm_mesh

    assert not torch.distributed.is_initialized() and parallel.device_backend() is None
    x = torch.arange(6.0, requires_grad=True)
    one = parallel.get_mesh()
    for mesh in (None, one):
        assert parallel.all_reduce_sum(x.detach().clone(), mesh).tolist() == x.tolist()
        y = parallel.differentiable_all_reduce_sum(x, mesh)
        (y * y).sum().backward()
        assert torch.equal(y, x) and torch.equal(x.grad, 2 * x.detach())
        x.grad = None
    with pytest.raises(ValueError, match="process group of 1"):
        parallel.all_reduce_sum(x.detach(), Mesh(2, 0, torch.device("cpu")))
    rng = np.random.RandomState(0)
    data = {"bn_scale": np.ones(6, np.float32), "bn_bias": np.zeros(6, np.float32),
            "bn_mean": np.zeros(6, np.float32), "bn_var": np.ones(6, np.float32)}
    x = (rng.randn(4, 16, 6) * 2 + 1).astype(np.float32)
    gy = rng.randn(4, 16, 6).astype(np.float32)
    plain = run_batch_norm(batch_norm(data), x, gy)
    bn = batch_norm(data)
    set_batch_norm_mesh(bn, one)
    assert bn.mesh is None
    for a, b in zip(run_batch_norm(bn, x, gy), plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("call", ["partial_fit", "train"])
def test_odd_batch_over_ranks_raises(call):
    """A batch of 7 over 2 ranks does not split: ValueError before any
    collective, as JAX's sharding constraint refuses it."""
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    conf = Configuration(**dict(TINY, batch_size=7))
    trainer = AETrainer(conf, "cpu", mesh=Mesh(2, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="7 rows do not split into 2"):
        if call == "partial_fit":
            trainer.partial_fit(tiny_clouds(7))
        else:
            trainer.train(None, conf)


# --- over 2 and 4 ranks ------------------------------------------------------
def test_cpu_ranks_sum_device_tensors_over_gloo(ranks):
    world, got = ranks
    for r in got:
        assert r["backend"].tolist() == ["gloo", "the ranks run on the CPU"]
        np.testing.assert_array_equal(r["ar_plain"], np.full(3, world * (world + 1) / 2))


def test_all_reduce_matches_autograd_on_the_whole_batch(ranks, inputs):
    world, got = ranks
    out, dx, s = run_all_reduce(inputs["x"], inputs["gx"], None)
    for rank, r in enumerate(got):
        rows = rank_rows(world, rank, len(out))
        np.testing.assert_allclose(r["ar_s"], s, **TOL)
        np.testing.assert_allclose(r["ar_out"], out[rows], **TOL)
        np.testing.assert_allclose(r["ar_dx"], dx[rows], **TOL)


def test_batch_norm_over_ranks_matches_one_process(ranks, inputs):
    world, got = ranks
    y, dx, dw, db, rm, rv = run_batch_norm(batch_norm(inputs), inputs["bn_x"],
                                           inputs["bn_gy"])
    for rank, r in enumerate(got):
        rows = rank_rows(world, rank, len(y))
        np.testing.assert_allclose(r["bn_y"], y[rows], **TOL)
        np.testing.assert_allclose(r["bn_dx"], dx[rows], **TOL)
        np.testing.assert_allclose(r["bn_dw"], dw.numpy(), **TOL)
        np.testing.assert_allclose(r["bn_db"], db.numpy(), **TOL)
        np.testing.assert_allclose(r["bn_rm"], rm, **TOL)
        np.testing.assert_allclose(r["bn_rv"], rv, **TOL)


def test_partial_fit_over_ranks_matches_jax(ranks, inputs):
    import jax

    from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax

    _, got = ranks
    jt, _ = jax_step()
    x = inputs["step"]
    state, loss, recon = jt._jit_train_step(jt.state, x, x)
    want = state_dict_from_flax(jax.tree.map(np.asarray, state.params),
                                jax.tree.map(np.asarray, state.batch_stats))
    for r in got:
        np.testing.assert_allclose(float(r["pf_loss"]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(r["pf_recon"], np.asarray(recon), atol=1e-4)
        for name, w in want.items():
            if "running_" in name or (name.startswith("encoder.conv_")
                                      and name.endswith(".bias")):
                continue  # parameters only; BN makes these biases degenerate
            assert np.abs(r["pf." + name] - w.numpy()).max() < 1e-4, name


def test_train_over_ranks_matches_one_process(ranks, inputs, tmp_path):
    """Per-epoch losses at rtol 1e-5. The held-out epochs, whose batches
    and augmentations come from numpy's stream (each rank seeded apart,
    then given the primary's), print the same on every rank: the losses
    of the batches one process seeded as the primary draws, within rtol
    1e-5 on rank 0's final weights for the second epoch, which wraps the
    held-out set. (The runs' own held-out losses differ by a few %: the
    eval forward's running means carry the encoder biases, which the batch
    norm makes degenerate and the rounding steers; tests/test_distributed.py:200-206.)"""
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    world, got = ranks
    stats, _, _ = train_run(inputs, str(tmp_path), None, 0)

    def held_out(log):
        return [ln.split("\t")[1] for ln in log if ln.startswith("On Held_Out")]

    conf = Configuration(**TRAIN)
    replay = AETrainer(conf, "cpu")
    replay.model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in got[0].items()
                                  if k.startswith("tr.") and not k.startswith("tr.adam.")})
    _, val = datasets(inputs)
    np.random.seed(NUMPY_SEED)
    replay._held_out_epoch(val, conf)
    second = replay._held_out_epoch(val, conf)[0]
    for r in got:
        np.testing.assert_allclose(r["tr_losses"], [s[1] for s in stats], rtol=1e-5)
        assert held_out(r["tr_log"]) == held_out(got[0]["tr_log"])
        assert len(held_out(r["tr_log"])) == 2
        np.testing.assert_allclose(float(held_out(r["tr_log"])[1]), second, rtol=1e-5)


def test_ranks_end_bit_equal(ranks):
    """Parameters, statistics and Adam moments after partial_fit and after
    train, and the replicated classifier, equal on every rank, bit for bit;
    so are the gathered reconstructions and labels."""
    _, got = ranks
    names = [k for k in got[0] if k.split(".")[0] in ("pf", "tr", "cls")]
    assert any(k.startswith("tr.adam.") and k.endswith("exp_avg_sq") for k in names)
    for r in got[1:]:
        for k in names + ["pf_recon", "pf_loss", "tr_losses", "cls_labels"]:
            np.testing.assert_array_equal(r[k], got[0][k], err_msg=k)


def test_checkpoints_written_once_by_the_primary(ranks, project):
    from geometric_adv_tpu_torch.train import checkpoint as ckpt

    world, got = ranks
    train_dir = project / f"w{world}" / "train"
    assert sorted(os.listdir(train_dir / "checkpoints")) == ["1.pt", "2.pt"]
    state = ckpt.restore_checkpoint(str(train_dir), 2)["state_dict"]
    for name, v in state.items():
        np.testing.assert_array_equal(v.numpy(), got[0]["tr." + name], err_msg=name)
    cls_dir = project / f"w{world}" / "cls"
    assert sorted(os.listdir(cls_dir / "checkpoints")) == ["1.pt"]


def test_classify_over_ranks_matches_one_process(ranks, inputs):
    """7 clouds in chunks of 5: the first chunk pads to 6 over 2 ranks and
    to 8 over 4; the labels equal one process's on the same weights."""
    _, got = ranks
    cls = cls_trainer(None)
    cls.model.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in got[0].items()
                               if k.startswith("cls.")})
    want = cls.classify(inputs["probe"], batch_size=5)
    assert want.dtype == np.int8 and want.shape == (7,)
    for r in got:
        np.testing.assert_array_equal(r["cls_labels"], want)


def test_train_ae_over_four_ranks_matches_one_process(runs, project):
    from geometric_adv_tpu_torch.cli import train_ae

    _, got = runs(4)
    want = [s[1] for s in train_ae.main(train_ae_argv(str(project), "log/ae_1proc_4"))]
    for r in got:
        np.testing.assert_allclose(r["ae_losses"], want, rtol=1e-5)
    lines = open(project / "log/ae_4proc/train_stats.txt").read().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == ["0001", "0002"]


# --- train_ae as 2 CLI processes ---------------------------------------------
def train_ae_processes(d, world, folder):
    """train_ae in ``world`` processes, started with the GAT_ variables;
    -> each process's per-epoch losses as it printed them."""
    argv = [sys.executable, "-m", "geometric_adv_tpu_torch.cli.train_ae",
            *train_ae_argv(d, folder)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(THREADS))
    port = free_port()
    procs = []
    for rank in range(world):
        e = dict(env)
        if world > 1:
            e.update(GAT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                     GAT_NUM_PROCESSES=str(world), GAT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(argv, env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    return [[float(ln.split("loss=")[1]) for ln in text.splitlines()
             if ln.startswith("Epoch:")] for text in outs]


def test_train_ae_two_cli_processes_match_one(project):
    """tests/test_distributed.py:186 and :215-223: per-epoch losses at rtol
    1e-5 on every rank; the checkpoints restored, reconstructions of 8 test
    clouds at atol 5e-3 and their loss at rtol 5e-3; the configuration
    saved and train_stats.txt written once."""
    from geometric_adv_tpu_torch.data.datasets import load_dataset
    from geometric_adv_tpu_torch.train import checkpoint as ckpt
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import build_trainer_from_checkpoint

    d = str(project)
    (single,) = train_ae_processes(d, 1, "log/ae_1proc")
    multi = train_ae_processes(d, 2, "log/ae_2proc")
    assert len(single) == 2
    for losses in multi:
        np.testing.assert_allclose(losses, single, rtol=1e-5)
    folders = [osp.join(d, f) for f in ("log/ae_1proc", "log/ae_2proc")]
    for folder in folders:
        lines = open(osp.join(folder, "train_stats.txt")).read().splitlines()
        assert [ln.split("\t")[0] for ln in lines] == ["0001", "0002"], lines
    confs = [Configuration.load(osp.join(f, "configuration")).to_dict() for f in folders]
    assert {**confs[0], "train_dir": None} == {**confs[1], "train_dir": None}
    epoch = ckpt.latest_epoch(folders[0])
    assert epoch is not None and ckpt.latest_epoch(folders[1]) == epoch
    probe = load_dataset(["sphere", "cube"], "train_set", osp.join(d, "data/tiny"))[0][:8]
    conf = Configuration.load(osp.join(folders[0], "configuration"))
    recons, losses = zip(*[build_trainer_from_checkpoint(conf, f, epoch, "cpu")
                           .reconstruct(probe) for f in folders])
    np.testing.assert_allclose(recons[1], recons[0], atol=5e-3)
    np.testing.assert_allclose(losses[1], losses[0], rtol=5e-3)
