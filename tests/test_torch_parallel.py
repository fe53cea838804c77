"""The port's ``parallel/`` (the process mesh over torch.distributed, gloo on
the CPU) against one process and against the JAX package.

- units: ``pad_to_multiple`` bit-equal to the JAX function; the row
  ownership of ``shard_host_batch`` (process p owns rows [p*n/P, (p+1)*n/P)
  of each padded call); ``maybe_initialize_from_env`` with the ``GAT_`` and
  ``JAX_`` spellings (in spawned ranks) and as a no-op; ``gather_global``
  over 2 and 4 ranks; a size-1 mesh bit-equal to ``mesh=None``.
- ``AttackRunner`` over 2 processes: at a call of 8 pairs against one
  process at calls of 4 (each rank's call holds the single process's
  pairs), at rtol 1e-5 / atol 1e-6 (tests/test_distributed.py:120-121);
  and with JAX's ``init_pert`` draw injected, against the JAX package's
  single-process runner on bridged weights at the attack's parity bar
  (tests/test_attack.py:116-118), through a call that needs padding.
- over 4 processes (tests/test_distributed.py:226-293): the chamfer matrix
  (exact and screened) at rtol 1e-5 / atol 1e-7, the gathered
  reconstructions and losses at rtol 1e-5 / atol 1e-6,
  ``get_pre_symmetry_argmax`` equal, every rank holding the same values.
- ``run_attack`` as 2 CLI processes started with the ``GAT_`` variables:
  its ``.npy`` artifacts equal the single process's at the runner's bar,
  written by the primary, and ``attack_impl.json`` carries the flag under
  ``encoder_vjp``.

Each multi-process test spawns its ranks (a top-level function of this
module, started by ``torch.multiprocessing``) with a rendezvous port of its
own and a timeout; the single-process runs that they are held against are
spawned the same way, so both see the same threads.
"""

import json
import os
import os.path as osp
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from geometric_adv_tpu_torch import parallel
from geometric_adv_tpu_torch.parallel import Mesh

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TIMEOUT = 180  # seconds a spawned run may take
THREADS = 2  # torch threads of each rank: the ranks share the host


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, nprocs, *args):
    """Run ``fn(rank, nprocs, port, *args)`` in ``nprocs`` spawned
    processes; raises if one fails or the run outlasts TIMEOUT."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(nprocs, free_port()) + args, nprocs=nprocs, join=False,
        start_method="spawn")
    deadline = time.time() + TIMEOUT
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} over {nprocs} processes "
                               f"outlasted {TIMEOUT} s")


def join_group(rank, world, port, spelling="GAT_"):
    """Start the rank as the CLIs do: the variables, then cli/common's call."""
    torch.set_num_threads(THREADS)
    if world > 1:
        os.environ[spelling + "COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        os.environ[spelling + "NUM_PROCESSES"] = str(world)
        os.environ[spelling + "PROCESS_ID"] = str(rank)
        assert parallel.maybe_initialize_from_env()
        assert not parallel.maybe_initialize_from_env()  # already up
    mesh = parallel.get_mesh()
    assert (mesh.size, mesh.rank) == (world, rank)
    return mesh


# --- units -------------------------------------------------------------------
@pytest.mark.parametrize("shape,multiple,axis", [
    ((5, 3), 2, 0), ((8, 2), 4, 0), ((7, 4, 3), 4, 0), ((3, 5, 2), 4, 1),
    ((1, 6), 8, 0), ((0, 3), 2, 0),
])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    from geometric_adv_tpu.parallel.mesh import pad_to_multiple as jax_pad

    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got, n = parallel.pad_to_multiple(x, multiple, axis)
    want, n_want = jax_pad(x, multiple, axis)
    assert n == n_want and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parts,n", [(2, 8), (2, 7), (4, 8), (4, 10), (4, 3)])
def test_shard_host_batch_row_ownership(parts, n):
    """Process p holds rows [p*n/P, (p+1)*n/P) of the padded batch, on its
    device; the ranks' rows in rank order are the padded batch."""
    batch = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    padded, n_orig = parallel.pad_to_multiple(batch, parts)
    assert n_orig == n and len(padded) % parts == 0
    w = len(padded) // parts
    rows = []
    for p in range(parts):
        mesh = Mesh(parts, p, torch.device("cpu"))
        got = parallel.shard_host_batch(padded, mesh)
        assert got.device == mesh.device
        np.testing.assert_array_equal(got.numpy(), padded[p * w:(p + 1) * w])
        assert parallel.batch_sharding(mesh).rows(len(padded)) == slice(p * w, (p + 1) * w)
        assert parallel.replicated(mesh).rows(len(padded)) == slice(0, len(padded))
        rows.append(got.numpy())
    np.testing.assert_array_equal(np.concatenate(rows), padded)
    with pytest.raises(ValueError, match="equal parts"):
        parallel.batch_sharding(Mesh(parts, 0, torch.device("cpu"))).rows(parts + 1)


def test_single_process_mesh_and_env_noop(monkeypatch):
    """With no variables or a count of 1 the start-up does nothing; the
    mesh is then of size 1, primary, and the collectives are local."""
    for spelling in ("GAT_", "JAX_"):
        for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
            monkeypatch.delenv(spelling + name, raising=False)
    assert not parallel.maybe_initialize_from_env()
    monkeypatch.setenv("GAT_NUM_PROCESSES", "1")
    assert not parallel.maybe_initialize_from_env()
    assert not parallel.initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    mesh = parallel.get_mesh()
    assert (mesh.size, mesh.rank) == (1, 0) and parallel.get_mesh(1) == mesh
    with pytest.raises(ValueError, match="process group"):
        parallel.get_mesh(2)
    assert parallel.is_primary()
    parallel.barrier()
    x = torch.arange(6.0).reshape(2, 3)
    out = parallel.gather_global({"a": x, "b": (np.ones(2, np.int32),)})
    assert isinstance(out["a"], np.ndarray) and isinstance(out["b"], tuple)
    np.testing.assert_array_equal(out["a"], x.numpy())
    np.testing.assert_array_equal(parallel.make_global_replicated(x.numpy(), mesh), x)
    np.testing.assert_array_equal(
        parallel.host_local_batch_to_global(x.numpy(), mesh), x)


def _gather_worker(rank, world, port, spelling, out_dir):
    mesh = join_group(rank, world, port, spelling)
    assert parallel.is_primary() == (rank == 0)
    batch, n = parallel.pad_to_multiple(
        np.arange(7 * 2, dtype=np.float32).reshape(7, 2), world)
    local = parallel.shard_host_batch(batch, mesh)
    ints = (local * 10).to(torch.int32)
    wide = np.stack([local.numpy(), -local.numpy()])  # rows on axis 1
    got = parallel.gather_global({"rows": local, "ints": ints})
    (wide,) = parallel.gather_global((wide,), axis=1)
    got2 = parallel.gather_global(
        parallel.host_local_batch_to_global(np.full((2, 3), rank, np.int64), mesh))
    parallel.barrier()
    np.savez(osp.join(out_dir, f"rank{rank}.npz"), rows=got["rows"], ints=got["ints"],
             wide=wide, n=n, local=got2)


@pytest.mark.parametrize("world,spelling", [(2, "GAT_"), (4, "JAX_")])
def test_gather_global_over_ranks(world, spelling, tmp_path):
    """Ranks started from the ``GAT_`` / ``JAX_`` variables each gather the
    whole arrays in rank order, along the axis asked, dtypes kept."""
    spawn(_gather_worker, world, spelling, str(tmp_path))
    batch, _ = parallel.pad_to_multiple(
        np.arange(7 * 2, dtype=np.float32).reshape(7, 2), world)
    for rank in range(world):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_array_equal(got["rows"], batch)
        assert got["ints"].dtype == np.int32
        np.testing.assert_array_equal(got["ints"], (batch * 10).astype(np.int32))
        np.testing.assert_array_equal(got["wide"], np.stack([batch, -batch]))
        np.testing.assert_array_equal(
            got["local"], np.repeat(np.arange(world), 2)[:, None] * np.ones(3))


def test_size_one_mesh_is_no_mesh():
    """Callers treat a size-1 mesh exactly as ``mesh=None``: the runner, the
    batched forward and the chamfer matrix give the same bits."""
    from geometric_adv_tpu_torch.attack.core import AttackRunner
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    mesh = parallel.get_mesh()
    assert mesh.size == 1
    conf = runner_conf()
    rng = np.random.RandomState(3)
    clouds = rng.rand(9, 32, 3).astype(np.float32) - 0.5
    outs = []
    for m in (None, mesh):
        trainer = AETrainer(Configuration(**conf), "cpu", mesh=m)
        assert trainer.mesh is None
        runner = AttackRunner(trainer.model, Configuration(**conf), "cpu", mesh=m)
        assert runner.mesh is None
        att = runner.attack(clouds[:5], trainer.get_latent_vectors(clouds[4:]),
                            clouds[4:], np.ones(5, np.float32), batch_size=3)
        outs.append([*att, trainer.get_reconstructions(clouds, batch_size=4),
                     *trainer.get_pre_symmetry_argmax(clouds),
                     chamfer_distance_matrix(clouds, "cpu", pair_block=7, mesh=m)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# --- the attack runner over 2 processes ---------------------------------------
def runner_conf():
    """tests/test_attack.py's tiny victim and attack, as port config fields."""
    return dict(n_input=[32, 3], bneck_size=8, encoder_filters=[16, 8],
                decoder_sizes=[16, 16], loss="chamfer", loss_adv_type="chamfer",
                loss_dist_type="chamfer", dist_weight_list=[0.5, 2.0],
                num_iterations=8, num_iterations_thresh=4, learning_rate=0.01)


def _runner_worker(rank, world, port, data_dir, runs):
    """Attack the saved pairs for each (name, call batch, injected init)."""
    from geometric_adv_tpu_torch.attack.core import AttackRunner
    from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE
    from geometric_adv_tpu_torch.train.config import Configuration

    mesh = join_group(rank, world, port)
    conf = Configuration(**runner_conf())
    model = PointNetAE(n_points=32, bneck_size=8, encoder_filters=[16, 8],
                       decoder_sizes=[16, 16])
    model.load_state_dict(torch.load(osp.join(data_dir, "victim.pt")))
    runner = AttackRunner(model, conf, "cpu", mesh=mesh)
    assert runner.chamfer_method == "auto"
    for name, batch, inject in runs:
        data = np.load(osp.join(data_dir, f"{name}.npz"))
        out = runner.attack(data["src"], data["tz"], data["tgt"], data["ref"],
                            batch_size=batch, pert0=data["pert0"] if inject else None)
        np.savez(osp.join(data_dir, f"{name}_{world}proc_rank{rank}.npz"), *out)


def jax_tiny_victim():
    import jax
    import jax.numpy as jnp

    from geometric_adv_tpu.models import PointNetAE as JaxAE
    from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax

    jmodel = JaxAE(n_points=32, bneck_size=8, encoder_filters=[16, 8],
                   decoder_sizes=[16, 16])
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 3)), train=False)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]))
    return jmodel, variables, sd


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    """Two inputs on the bridged JAX victim: 8 pairs (seeded init) attacked
    by 2 ranks at calls of 8 and by one process at calls of 4; 7 pairs
    with JAX's init draw attacked by 2 ranks in one call of 8 (padded) and
    by the JAX package's runner in one call of 7."""
    import jax

    from geometric_adv_tpu.attack.core import AttackRunner as JaxRunner
    from geometric_adv_tpu.attack.core import init_pert as jax_init_pert
    from geometric_adv_tpu.models import PointNetAE as JaxAE
    from geometric_adv_tpu.train import Configuration as JaxConf

    d = tmp_path_factory.mktemp("runner")
    jmodel, variables, sd = jax_tiny_victim()
    torch.save(sd, d / "victim.pt")
    encode = jax.jit(lambda x: jmodel.apply(variables, x, train=False,
                                            method=JaxAE.encode))
    rng = np.random.RandomState(7)
    for name, n in (("even", 8), ("padded", 7)):
        src = rng.rand(n, 32, 3).astype(np.float32) - 0.5
        tgt = rng.rand(n, 32, 3).astype(np.float32) - 0.5
        np.savez(d / f"{name}.npz", src=src, tgt=tgt, tz=np.asarray(encode(tgt)),
                 ref=rng.rand(n).astype(np.float32) + 0.5,
                 pert0=np.asarray(jax_init_pert((n, 32, 3))))
    spawn(_runner_worker, 2, str(d), [("even", 8, False), ("padded", 8, True)])
    spawn(_runner_worker, 1, str(d), [("even", 4, False)])
    data = np.load(d / "padded.npz")
    jax_runner = JaxRunner(jmodel, variables["params"], variables["batch_stats"],
                           JaxConf(**runner_conf()))
    want = jax_runner.attack(data["src"], data["tz"], data["tgt"], data["ref"],
                             batch_size=7)
    return d, [np.asarray(a) for a in want]


def load_outputs(path):
    got = np.load(path)
    return [got[f"arr_{i}"] for i in range(3)]


def test_runner_two_processes_match_one(runner_runs):
    d, _ = runner_runs
    want = load_outputs(d / "even_1proc_rank0.npz")
    assert want[0].shape == (2, 8, 5)
    for rank in range(2):
        got = load_outputs(d / f"even_2proc_rank{rank}.npz")
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_runner_two_processes_match_jax(runner_runs):
    d, want = runner_runs
    for rank in range(2):
        got = load_outputs(d / f"padded_2proc_rank{rank}.npz")
        assert got[0].shape == want[0].shape == (2, 7, 5)
        np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# --- the chamfer matrix and the batched forward over 4 processes -------------
def forward_conf():
    """tests/test_distributed.py:261-265's victim."""
    return dict(n_input=[32, 3], bneck_size=8, encoder_filters=[8, 16, 8],
                decoder_sizes=[16, 16], batch_size=8, learning_rate=0.01)


def _stages_worker(rank, world, port, data_dir):
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    mesh = join_group(rank, world, port)
    data = np.load(osp.join(data_dir, "inputs.npz"))
    trainer = AETrainer(Configuration(**forward_conf()), "cpu", mesh=mesh)
    amax, vmax = trainer.get_pre_symmetry_argmax(data["probe"], batch_size=14)
    np.savez(
        osp.join(data_dir, f"rank{rank}.npz"),
        matrix=chamfer_distance_matrix(data["clouds"], "cpu", pair_block=8,
                                       blocks_per_chunk=3, mesh=mesh),
        screened=chamfer_distance_matrix(data["clouds"], "cpu", pair_block=6,
                                         screen_chunks=4, screen_k=2, mesh=mesh),
        recon=trainer.get_reconstructions(data["probe"], batch_size=14),
        loss=trainer.get_loss_per_pc(data["probe"], batch_size=5),
        amax=amax, vmax=vmax)


@pytest.fixture(scope="module")
def four_rank_stages(tmp_path_factory):
    d = tmp_path_factory.mktemp("stages")
    np.savez(d / "inputs.npz",
             clouds=np.random.RandomState(11).rand(10, 32, 3).astype(np.float32),
             probe=np.random.RandomState(12).rand(14, 32, 3).astype(np.float32) - 0.5)
    spawn(_stages_worker, 4, str(d))
    return d, [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def test_four_processes_agree(four_rank_stages):
    _, ranks = four_rank_stages
    for other in ranks[1:]:
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_four_process_matrix_matches_single(four_rank_stages):
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix

    d, ranks = four_rank_stages
    clouds = np.load(d / "inputs.npz")["clouds"]
    exact = chamfer_distance_matrix(clouds, "cpu", pair_block=8, blocks_per_chunk=3)
    np.testing.assert_allclose(ranks[0]["matrix"], exact, rtol=1e-5, atol=1e-7)
    screened = chamfer_distance_matrix(clouds, "cpu", pair_block=6,
                                       screen_chunks=4, screen_k=2)
    np.testing.assert_allclose(ranks[0]["screened"], screened, rtol=1e-5, atol=1e-7)


def test_four_process_forward_matches_single(four_rank_stages):
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    d, ranks = four_rank_stages
    probe = np.load(d / "inputs.npz")["probe"]
    trainer = AETrainer(Configuration(**forward_conf()), "cpu")
    np.testing.assert_allclose(ranks[0]["recon"],
                               trainer.get_reconstructions(probe, batch_size=14),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["loss"],
                               trainer.get_loss_per_pc(probe, batch_size=5),
                               rtol=1e-5, atol=1e-6)
    amax, vmax = trainer.get_pre_symmetry_argmax(probe, batch_size=14)
    np.testing.assert_array_equal(ranks[0]["amax"], amax)
    np.testing.assert_allclose(ranks[0]["vmax"], vmax, rtol=1e-5, atol=1e-6)


# --- run_attack as 2 CLI processes -------------------------------------------
@pytest.fixture(scope="module")
def cli_project(tmp_path_factory):
    """A chamfer victim trained one epoch by the port's train_ae, its eval
    dump and pair indices (tests/test_torch_attack.py::tiny_project)."""
    from geometric_adv_tpu_torch.cli import prepare_indices_for_attack, train_ae, tst_ae
    from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir

    d = str(tmp_path_factory.mktemp("attack_mesh_cli"))
    ae = "log/ae"
    make_shapenet_like_dir(osp.join(d, "data/tiny"), ["sphere", "cube"], 30, 64)
    c = ["--project_dir", d, "--device", "cpu"]
    train_ae.main(c + ["--data_folder", "data/tiny", "--n_points", "64",
                       "--bneck_size", "16", "--batch_size", "10",
                       "--training_epochs", "1", "--train_folder", ae])
    tst_ae.main(c + ["--data_folder", "data/tiny", "--train_folder", ae])
    prepare_indices_for_attack.main(c + [
        "--ae_folder", ae, "--get_rand_idx", "1", "--get_latent_nn_idx", "1",
        "--get_chamfer_nn_idx", "1", "--num_instance_per_class", "2"])
    return d, ae


def run_attack_processes(d, ae, world, batch, out):
    """run_attack in ``world`` processes, started with the GAT_ variables."""
    argv = [sys.executable, "-m", "geometric_adv_tpu_torch.cli.run_attack",
            "--project_dir", d, "--device", "cpu", "--ae_folder", ae,
            "--attack_pc_idx", f"{ae}/eval/sel_idx_rand_2_test_set_13l.npy",
            "--num_pc_for_attack", "2", "--num_pc_for_target", "2",
            "--num_iterations", "6", "--num_iterations_thresh", "3",
            "--batch_size", str(batch), "--output_folder_name", out]
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
    return osp.join(d, ae, "eval", out)


def test_run_attack_two_cli_processes_match_one(cli_project):
    """Two ranks at calls of 4 pairs write, from the primary, what one
    process writes at calls of 2; attack_impl.json holds the flag under
    ``encoder_vjp`` and the path taken under ``encoder_vjp_path``."""
    d, ae = cli_project
    single = run_attack_processes(d, ae, 1, 2, "attack_1proc")
    sharded = run_attack_processes(d, ae, 2, 4, "attack_2proc")
    for cls in ("sphere", "cube"):
        for name in ("adversarial_metrics", "adversarial_pc_input",
                     "adversarial_pc_recon", "dist_weight"):
            want = np.load(osp.join(single, cls, name + ".npy"))
            got = np.load(osp.join(sharded, cls, name + ".npy"))
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
        assert np.load(osp.join(sharded, cls, "adversarial_metrics.npy")).shape == (1, 4, 5)
    impl = [json.load(open(osp.join(p, "attack_impl.json"))) for p in (single, sharded)]
    assert [i["processes"] for i in impl] == [1, 2]
    assert [i["batch_size"] for i in impl] == [2, 4]
    for i in impl:
        assert i["encoder_vjp"] == "auto" and i["encoder_vjp_path"] == "dense"
        assert i["chamfer_method"] == "auto"
