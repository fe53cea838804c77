"""The port stands alone, and its copies of numpy-only modules stay equal to
their originals in the JAX package.

1. In a fresh interpreter where ``jax``, ``flax``, ``optax``, ``orbax``, the
   JAX package itself and matplotlib, pandas, seaborn and tensorflow (absent
   on the card's machine) cannot be imported, every module of
   ``geometric_adv_tpu_torch`` imports and the tiny slice runs through the
   stage CLIs on ``--device cpu``, from ``make_synthetic_data`` and
   ``train_ae --loss emd`` through the attack (also with ``--encoder_vjp
   sparse``, and in 2 processes started with the ``GAT_`` variables, each
   rank with the same modules blocked) and both defenses, then ``train_classifier``,
   ``run_classifier``, ``train_transfer`` (AtlasNet and FoldingNet),
   ``run_metro`` and ``import_reference_ckpt --model atlasnet`` with
   ``tst_transfer`` on what it wrote — as on a machine that has no JAX and
   no tensorflow; so do a frozen-assignment attack and the pruned chamfer
   of ``ops/chamfer_hier.py``, and a plot call raises ImportError.
2. The copies (``attack/pipeline.py``, ``train/config.py`` and the data /
   augmentation / artifact / statistics helpers, and the public helpers no
   stage calls: ``Configuration.copy``, ``exists_and_is_not_none`` and
   ``resolved_n_output``, ``artifact_name`` and ``save_artifact``,
   ``ThroughputMeter``, ``plot_3d_point_cloud``, ``euler2mat`` and
   ``jitter_point_cloud``) give the originals' results on the same inputs;
   ``log_compile_time`` times one call in the port's idiom.
"""

import io
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

STANDALONE = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "flax", "optax", "orbax", "geometric_adv_tpu", "matplotlib",
           "pandas", "seaborn", "tensorflow")
for name in BLOCKED:
    sys.modules[name] = None  # any import of them now raises ImportError
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)  # the run shares the host with the other test workers
import geometric_adv_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("cli.run_attack", "cli.train_ae", "ops.emd", "ops.cuda.emd",
             "ops.cuda.build", "ops.chamfer_hier", "train.trainer",
             "cli.run_defense_critical", "cli.run_defense_surface",
             "cli.get_knn_dists_per_point", "cli.evaluate_defense",
             "cli.make_synthetic_data", "ops.grouping", "utils.plots",
             "utils.profiling", "classify.trainer", "models.pointnet_cls",
             "models.atlasnet", "models.foldingnet", "transfer.trainers",
             "transfer.metro", "cli.train_classifier", "cli.tst_classifier",
             "cli.run_classifier", "cli.evaluate_classifier", "cli.train_transfer",
             "cli.tst_transfer", "cli.run_transfer", "cli.evaluate_transfer",
             "cli.run_metro", "cli.import_reference_ckpt", "cli.verify_cuda",
             "train.import_tf", "train.import_torch", "models.sparse_encode",
             "native", "parallel", "parallel.mesh", "parallel.distributed"):
    assert "geometric_adv_tpu_torch." + name in names, names

import numpy as np
from geometric_adv_tpu_torch.cli import (
    evaluate_attack, evaluate_defense, get_dists_per_point,
    get_knn_dists_per_point, make_synthetic_data, prepare_indices_for_attack,
    run_attack, run_defense_critical, run_defense_surface, train_ae, tst_ae)

d, ae = sys.argv[2], "log/ae"
make_synthetic_data.main(["--project_dir", d, "--data_folder", "data/tiny",
                          "--class_names", "sphere", "cube", "torus",
                          "--n_per_class", "40", "--n_points", "64"])
c = ["--project_dir", d, "--device", "cpu"]
sel = ae + "/eval/sel_idx_rand_4_test_set_13l.npy"
train_ae.main(c + ["--data_folder", "data/tiny", "--n_points", "64",
                   "--bneck_size", "16", "--batch_size", "10", "--loss", "emd",
                   "--training_epochs", "1", "--train_folder", ae])
tst_ae.main(c + ["--data_folder", "data/tiny", "--train_folder", ae])
prepare_indices_for_attack.main(c + [
    "--ae_folder", ae, "--get_rand_idx", "1", "--get_latent_nn_idx", "1",
    "--get_chamfer_nn_idx", "1", "--num_instance_per_class", "4"])
run_attack.main(c + ["--ae_folder", ae, "--attack_pc_idx", sel,
                     "--num_pc_for_attack", "2", "--num_pc_for_target", "2",
                     "--num_iterations", "5", "--num_iterations_thresh", "3"])
get_dists_per_point.main(c + ["--ae_folder", ae, "--attack_pc_idx", sel])
evaluate_attack.main(["--project_dir", d, "--ae_folder", ae,
                      "--attack_pc_idx", sel])
m = np.load(d + "/" + ae + "/eval/attack_res/sphere/adversarial_metrics.npy")
assert m.shape == (1, 8, 5) and np.isfinite(m).all(), m
run_attack.main(c + ["--ae_folder", ae, "--attack_pc_idx", sel,
                     "--num_pc_for_attack", "2", "--num_pc_for_target", "2",
                     "--num_iterations", "5", "--num_iterations_thresh", "3",
                     "--encoder_vjp", "sparse", "--output_folder_name", "attack_sparse"])
m = np.load(d + "/" + ae + "/eval/attack_sparse/sphere/adversarial_metrics.npy")
assert m.shape == (1, 8, 5) and np.isfinite(m).all(), m
# the same attack in 2 processes started with the GAT_ variables, each
# rank with the same modules blocked
import json, os, socket, subprocess
RANK = ("import sys\nfor name in %r:\n    sys.modules[name] = None\n"
        "sys.path.insert(0, %r)\nfrom geometric_adv_tpu_torch.cli import run_attack\n"
        "run_attack.main(sys.argv[1:])\n"
        "leaked = [k for k, v in sys.modules.items() if v is not None and "
        "k.split('.')[0] in %r]\nassert not leaked, leaked\n") % (
            BLOCKED, sys.argv[1], BLOCKED)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
ranks = [subprocess.Popen(
    [sys.executable, "-c", RANK] + c + ["--ae_folder", ae, "--attack_pc_idx", sel,
     "--num_pc_for_attack", "2", "--num_pc_for_target", "2", "--num_iterations", "5",
     "--num_iterations_thresh", "3", "--batch_size", "8", "--output_folder_name",
     "attack_mesh"],
    env=dict(os.environ, OMP_NUM_THREADS="2", GAT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
             GAT_NUM_PROCESSES="2", GAT_PROCESS_ID=str(r))) for r in range(2)]
assert [p.wait(timeout=120) for p in ranks] == [0, 0]
impl = json.load(open(d + "/" + ae + "/eval/attack_mesh/attack_impl.json"))
assert impl["processes"] == 2 and impl["encoder_vjp"] == "auto", impl
m = np.load(d + "/" + ae + "/eval/attack_mesh/sphere/adversarial_metrics.npy")
assert m.shape == (1, 8, 5) and np.isfinite(m).all(), m
a = ["--ae_folder", ae, "--attack_pc_idx", sel]
run_defense_critical.main(c + a + ["--do_sanity_checks", "1"])
get_knn_dists_per_point.main(c + a)
run_defense_surface.main(c + a)
for defense in ("defense_critical_res", "defense_surface_res"):
    evaluate_defense.main(["--project_dir", d, "--defense_folder", defense] + a)
    m = np.load(f"{d}/{ae}/eval/attack_res/{defense}/sphere/defense_metrics.npy")
    assert m.shape == (1, 8, 4) and np.isfinite(m).all(), m
from geometric_adv_tpu_torch.cli import (
    run_classifier, run_metro, train_classifier, train_transfer)
# the evaluation models train on a smaller split: 17 clouds a class
make_synthetic_data.main(["--project_dir", d, "--data_folder", "data/micro",
                          "--class_names", "sphere", "cube", "torus",
                          "--n_per_class", "20", "--n_points", "64"])
train_classifier.main(c + ["--ae_folder", ae, "--data_folder", "data/micro",
                           "--max_epoch", "1", "--batch_size", "8",
                           "--train_folder", "log/cls"])
labels = np.load(d + "/" + ae + "/eval/pc_pred_labels_test_set_13l.npy")
assert labels.shape == (12,) and labels.dtype == np.int8, labels
run_classifier.main(c + a + ["--classifier_folder", "log/cls",
                             "--data_type", "after_defense"])
for kind, extra in (("atlasnet", ["--number_points", "36", "--template_type", "SQUARE"]),
                    ("foldingnet", [])):
    train_transfer.main(c + ["--ae_type", kind, "--ae_folder", ae, "--data_folder",
                             "data/micro", "--epochs", "1", "--batch_size", "8"] + extra)
rows = run_metro.main(c + ["--transfer_ae_folder", "log/atlasnet_for_transfer",
                           "--ae_folder", ae, "--n_samples", "200"])
assert len(rows) == 6 and all(np.isfinite(r[1]) for r in rows), rows
# a reference-layout AtlasNet network.pth (one SQUARE primitive) through
# the importer, restored by tst_transfer from the arch.json it wrote
from geometric_adv_tpu_torch.cli import import_reference_ckpt, tst_transfer
g = torch.Generator().manual_seed(0)
sd = {}
def dense(base, i, o, conv=True):
    sd[f"module.{base}.weight"] = torch.randn((o, i, 1) if conv else (o, i), generator=g) / i ** 0.5
    sd[f"module.{base}.bias"] = torch.zeros(o)
def bn(base, ch):
    for k, v in (("weight", torch.ones(ch)), ("bias", torch.zeros(ch)),
                 ("running_mean", torch.zeros(ch)), ("running_var", torch.ones(ch))):
        sd[f"module.{base}.{k}"] = v
for i, (fan_in, width) in enumerate(((3, 64), (64, 128), (128, 1024)), 1):
    dense(f"encoder.conv{i}", fan_in, width)
    bn(f"encoder.bn{i}", width)
for i in (1, 2):
    dense(f"encoder.lin{i}", 1024, 1024, conv=False)
    bn(f"encoder.bn{i + 3}", 1024)
p = "decoder.decoder.0"
dense(p + ".conv1", 2, 1024); bn(p + ".bn1", 1024)
dense(p + ".conv2", 1024, 512); bn(p + ".bn2", 512)
for i in (0, 1):
    dense(f"{p}.conv_list.{i}", 512, 512); bn(f"{p}.bn_list.{i}", 512)
dense(p + ".last_conv", 512, 3)
torch.save(sd, d + "/network.pth")
import_reference_ckpt.main(["--project_dir", d, "--model", "atlasnet", "--reference_ckpt",
                            d + "/network.pth", "--train_folder", "log/atlas_ref"])
ev = tst_transfer.main(c + ["--ae_folder", ae, "--ae_type", "atlasnet",
                            "--train_folder", "log/atlas_ref"])
assert np.isfinite(ev["loss"]), ev
from geometric_adv_tpu_torch.utils import plots
for plot in (lambda: plots.plot_attack_triplet(*np.zeros((3, 4, 3)), d + "/p.png"),
             lambda: plots.plot_3d_point_cloud(np.zeros((4, 3)), save_path=d + "/q.png")):
    try:
        plot()
        raise AssertionError("a plot call ran without matplotlib")
    except ImportError:
        pass

import torch
from geometric_adv_tpu_torch.attack.core import attack_batch
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE
from geometric_adv_tpu_torch.ops.chamfer import nn_distance
from geometric_adv_tpu_torch.ops.chamfer_hier import nn_distance_hier
torch.manual_seed(0)
net = PointNetAE(n_points=32, bneck_size=8, encoder_filters=[16, 8],
                 decoder_sizes=[16, 16]).eval().requires_grad_(False)
x, gt = torch.rand(2, 32, 3), torch.rand(2, 32, 3)
out = attack_batch(net.encode, net.decode, x, net.encode(gt), gt, torch.ones(2),
                   [1.0], num_iterations=6, num_iterations_thresh=2,
                   chamfer_refresh=3)
assert np.isfinite(out.metrics).all(), out.metrics
for a, b in zip(nn_distance_hier(x, gt), nn_distance(x, gt)):
    assert torch.equal(a, b)
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and k.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("STANDALONE OK", len(names), "modules")
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", STANDALONE, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "STANDALONE OK" in res.stdout


def test_cli_device_cuda_raises_without_cuda(tmp_path):
    """No silent move to the CPU: --device cuda on a host without CUDA
    raises before any stage work."""
    torch = pytest.importorskip("torch")
    from geometric_adv_tpu_torch.cli.common import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    # the once-rejected precision now runs: full float32 on the CPU
    assert resolve_device("cpu", matmul_precision="bfloat16").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32


NEW_CLIS = {  # the classifier and transfer CLIs, with their required flags
    "train_classifier": [], "tst_classifier": [],
    "run_classifier": ["--attack_pc_idx", "x.npy"],
    "evaluate_classifier": ["--attack_pc_idx", "x.npy"],
    "train_transfer": [], "tst_transfer": ["--train_folder", "t"],
    "run_transfer": ["--attack_pc_idx", "x.npy", "--transfer_ae_folder", "t"],
    "evaluate_transfer": ["--attack_pc_idx", "x.npy"], "run_metro": [],
}


@pytest.mark.parametrize("stage", sorted(NEW_CLIS))
def test_new_cli_device_cuda_raises_without_cuda(stage, tmp_path):
    """Each classifier and transfer CLI takes ``--device`` (default cuda) and
    raises on a host without CUDA before any stage work."""
    import importlib

    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    mod = importlib.import_module(f"geometric_adv_tpu_torch.cli.{stage}")
    argv = ["--project_dir", str(tmp_path)] + NEW_CLIS[stage]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv + extra)
    assert list(tmp_path.iterdir()) == []


def _grid_inputs(seed):
    rng = np.random.RandomState(seed)
    slice_idx = [0, 7, 15, 24]
    data = rng.rand(24, 5, 3).astype(np.float32)
    mat = rng.rand(24, 24).astype(np.float32)
    attack_idx = np.stack([rng.permutation(n)[:3] for n in (7, 8, 9)])
    return rng, slice_idx, data, mat, attack_idx


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_copy_matches_original(seed):
    from geometric_adv_tpu.attack import pipeline as orig
    from geometric_adv_tpu_torch.attack import pipeline as copy

    rng, slice_idx, data, mat, attack_idx = _grid_inputs(seed)
    classes = np.array(["a", "b", "c"])
    np.testing.assert_array_equal(copy.sort_dist_mat(mat, slice_idx),
                                  orig.sort_dist_mat(mat, slice_idx))
    np.testing.assert_array_equal(copy.get_rand_idx(slice_idx, 4),
                                  orig.get_rand_idx(slice_idx, 4))
    lat = rng.randn(24, 6).astype(np.float32)
    np.testing.assert_array_equal(copy.latent_dist_matrix(lat),
                                  orig.latent_dist_matrix(lat))
    nn_idx = orig.sort_dist_mat(mat, slice_idx)
    correct = rng.rand(24) > 0.3
    for cp in (None, correct):
        args = (classes, ["b"], list(classes), data, slice_idx, attack_idx, 2,
                nn_idx, cp)
        for g, w in zip(copy.prepare_data_for_attack(*args),
                        orig.prepare_data_for_attack(*args)):
            np.testing.assert_array_equal(g, w)
    q = rng.rand(2, 12).astype(np.float32)
    dw = rng.randint(0, 2, 12)
    tidx = rng.randint(0, 2, (3, 2))
    uidx = rng.randint(0, 2, 3)
    for g, w in zip(
        copy.get_quantity_for_targeted_untargeted_attack(q, dw, tidx, uidx),
        orig.get_quantity_for_targeted_untargeted_attack(q, dw, tidx, uidx),
    ):
        np.testing.assert_array_equal(g, w)


def test_configuration_copy_round_trips_with_original(tmp_path):
    from geometric_adv_tpu.train.config import Configuration as Orig
    from geometric_adv_tpu_torch.train.config import Configuration as Copy

    a = Copy(n_input=[64, 3], bneck_size=16, dist_weight_list=[0.5, 2.0],
             gauss_augment={"mu": 0.0, "sigma": 0.01}, extra={"k": [1, 2]})
    a.save(str(tmp_path / "port"))
    b = Orig.load(str(tmp_path / "port"))
    assert b.to_dict() == a.to_dict()
    b.loss_adv_type = "latent"
    b.save(str(tmp_path / "jax"))
    c = Copy.load(str(tmp_path / "jax"))
    assert c.to_dict() == b.to_dict()
    assert str(c) == str(b)
    assert open(tmp_path / "jax.txt").read() == str(c)
    assert {f for f in Copy().to_dict()} == {f for f in Orig().to_dict()}
    from geometric_adv_tpu.train import config as orig_config
    from geometric_adv_tpu_torch.train import config as copy_config

    assert copy_config.default_train_params() == orig_config.default_train_params()


def test_configuration_helpers_match_original():
    from geometric_adv_tpu.train.config import Configuration as Orig
    from geometric_adv_tpu_torch.train.config import Configuration as Copy

    kw = dict(n_input=[64, 3], gauss_augment={"mu": 0.0, "sigma": [0.01]},
              extra={"k": [1, {"j": [2]}]})
    a, b = Copy(**kw), Orig(**kw)
    ca, cb = a.copy(), b.copy()
    assert ca.to_dict() == cb.to_dict() == a.to_dict()
    ca.gauss_augment["sigma"].append(1.0)
    ca.extra["k"][1]["j"].append(3)
    ca.n_input[0] = 32
    assert a.to_dict() == b.to_dict()  # the copy is deep
    for attr in ("n_output", "train_dir", "n_input", "gauss_augment", "missing"):
        assert a.exists_and_is_not_none(attr) == b.exists_and_is_not_none(attr)
    assert a.resolved_n_output() == b.resolved_n_output() == [64, 3]
    a.n_output = b.n_output = [32, 3]
    assert a.resolved_n_output() == b.resolved_n_output() == [32, 3]


def test_artifact_helpers_match_originals(tmp_path):
    from geometric_adv_tpu import utils as orig
    from geometric_adv_tpu_torch import utils as copy

    data = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    for args in (("point_clouds", "test_set", ["13l"]), ("ae_loss", None, "13l"),
                 ("latent", "train_set", ["a", "b"]), ("x", "", ())):
        assert copy.artifact_name(*args) == orig.artifact_name(*args)
        paths = [mod.save_artifact(str(tmp_path / name), args[0], data, *args[1:])
                 for mod, name in ((copy, "c"), (orig, "o"))]
        assert osp.basename(paths[0]) == osp.basename(paths[1])
        np.testing.assert_array_equal(np.load(paths[0]), np.load(paths[1]))
    assert copy.load_data(str(tmp_path / "c"), None, ["latent"]).shape == (3, 4)


def test_profiling_helpers(monkeypatch, capsys):
    """ThroughputMeter gives the original's rate and line on the same
    clock; log_compile_time makes one call, prints its time and returns the
    function."""
    from geometric_adv_tpu.utils import profiling as orig
    from geometric_adv_tpu_torch.utils import profiling as copy

    lines = []
    for mod in (copy, orig):
        ticks = iter([1.0, 1.5, 2.0, 4.25])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        meter = mod.ThroughputMeter("pair-iters")
        for n in (100, 300):
            with meter.measure(n_items=n):
                pass
        lines.append((str(meter), meter.rate, meter.calls))
    monkeypatch.undo()
    assert lines[0] == lines[1] and lines[0][1] == 400 / 2.75

    import torch

    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return {"y": torch.as_tensor(x) * scale}

    assert copy.log_compile_time(fn, 2.0, label="step", scale=3.0) is fn
    assert calls == [2.0]
    out = capsys.readouterr().out.strip()
    assert out.startswith("[profiling] step: first call ") and out.endswith("s")


def test_plot_3d_point_cloud_matches_original(tmp_path):
    import matplotlib.image

    from geometric_adv_tpu.utils import plots as orig
    from geometric_adv_tpu_torch.utils import plots as copy

    pc = np.random.RandomState(0).rand(50, 3) - 0.5
    images = []
    for mod, name in ((copy, "c.png"), (orig, "o.png")):
        mod.plot_3d_point_cloud(pc, title="t", elev=20, save_path=str(tmp_path / name))
        images.append(matplotlib.image.imread(str(tmp_path / name)))
    assert images[0].shape == images[1].shape
    np.testing.assert_array_equal(images[0], images[1])


def test_numpy_helpers_match_originals():
    from geometric_adv_tpu.classify.trainer import jitter_point_cloud as o_jitter
    from geometric_adv_tpu.data.augment import euler2mat as o_euler
    from geometric_adv_tpu_torch.classify.trainer import jitter_point_cloud
    from geometric_adv_tpu_torch.data.augment import euler2mat

    for rotation in ([0.1, -0.4, 2.0], [0.0, 0.0, np.pi / 2], [1.0, 2.0, 3.0]):
        for z_only in (True, False):
            got, want = euler2mat(rotation, z_only), o_euler(rotation, z_only)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    batch = np.random.RandomState(1).rand(2, 30, 3).astype(np.float32)
    for kw in (dict(), dict(sigma=0.05, clip=0.02)):
        got = jitter_point_cloud(batch, rng=np.random.RandomState(4), **kw)
        want = o_jitter(batch, rng=np.random.RandomState(4), **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_data_copies_match_originals(tmp_path):
    from geometric_adv_tpu.data import augment as o_aug
    from geometric_adv_tpu.data import datasets as o_ds
    from geometric_adv_tpu.data import ply as o_ply
    from geometric_adv_tpu.data import synthetic as o_syn
    from geometric_adv_tpu_torch.data import augment as c_aug
    from geometric_adv_tpu_torch.data import datasets as c_ds
    from geometric_adv_tpu_torch.data import ply as c_ply
    from geometric_adv_tpu_torch.data import synthetic as c_syn

    classes = list(o_syn.SHAPE_CLASSES)
    assert list(c_syn.SHAPE_CLASSES) == classes
    for k, name in enumerate(classes):
        np.testing.assert_array_equal(
            c_syn.sample_shape(name, 50, np.random.RandomState(k)),
            o_syn.sample_shape(name, 50, np.random.RandomState(k)))

    c_syn.make_shapenet_like_dir(str(tmp_path / "c"), classes[:3], 20, 32, seed=3)
    o_syn.make_shapenet_like_dir(str(tmp_path / "o"), classes[:3], 20, 32, seed=3)
    for set_type in ("train_set", "val_set", "test_set"):
        pcs, sl, lab = c_ds.load_dataset(classes[:3], set_type, str(tmp_path / "c"))
        ods, osl, olab = o_ds.load_dataset(classes[:3], set_type, str(tmp_path / "o"))
        np.testing.assert_array_equal(pcs, ods.point_clouds)
        assert sl == osl and lab == olab
        np.testing.assert_array_equal(c_aug.sort_axes(pcs),
                                      o_aug.sort_axes(ods.point_clouds))

    for name in classes:
        got = c_syn.sample_shape_and_mesh(name, 40, np.random.RandomState(5))
        want = o_syn.sample_shape_and_mesh(name, 40, np.random.RandomState(5))
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) == (name not in o_syn.MESHABLE_CLASSES)
        if want[1] is not None:
            for g, w in zip(got[1], want[1]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    for g, w in zip(c_syn.make_dataset(classes[:4], 5, 32, seed=2),
                    o_syn.make_dataset(classes[:4], 5, 32, seed=2)):
        np.testing.assert_array_equal(g, w)

    pts = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    for binary in (True, False):
        path = str(tmp_path / f"p{int(binary)}.ply")
        o_ply.save_ply(path, pts, binary=binary)
        np.testing.assert_array_equal(c_ply.load_ply(path), o_ply.load_ply(path))
    assert c_ds.snc_synth_id_to_category == o_ds.snc_synth_id_to_category


def test_augment_and_dataset_copies_match_originals():
    from geometric_adv_tpu.data import augment as o_aug
    from geometric_adv_tpu.data import datasets as o_ds
    from geometric_adv_tpu.train.config import Configuration
    from geometric_adv_tpu_torch.data import augment as c_aug
    from geometric_adv_tpu_torch.data import datasets as c_ds

    for kw in (dict(), dict(deflection=0.5, z_only=False)):
        np.testing.assert_array_equal(c_aug.rand_rotation_matrix(seed=4, **kw),
                                      o_aug.rand_rotation_matrix(seed=4, **kw))
    batch = np.random.RandomState(0).randn(3, 20, 3).astype(np.float32)
    for conf in (Configuration(), Configuration(z_rotate=True),
                 Configuration(gauss_augment={"mu": 0.1, "sigma": 0.02},
                               z_rotate=True)):
        outs = []
        for mod in (c_aug, o_aug):
            np.random.seed(9)
            outs.append(mod.apply_augmentations(batch, conf))
        np.testing.assert_array_equal(outs[0], outs[1])

    pcs = np.random.RandomState(1).rand(23, 8, 3).astype(np.float32)
    noise = pcs + 1.0
    sets = [mod.PointCloudDataSet(pcs, noise=noise, labels=np.arange(23),
                                  init_shuffle=False).shuffle_data(seed=55)
            for mod in (c_ds, o_ds)]
    for _ in range(7):  # wraps around once, reshuffling from numpy's stream
        np.random.seed(3)
        got = sets[0].next_batch(5)
        np.random.seed(3)
        want = sets[1].next_batch(5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert sets[0].n_points == 8 and sets[0].epochs_completed == 1


def test_utils_copies_match_originals(tmp_path):
    from geometric_adv_tpu.utils import artifacts as o_art
    from geometric_adv_tpu.utils import stats as o_stats
    from geometric_adv_tpu_torch.utils import artifacts as c_art
    from geometric_adv_tpu_torch.utils import stats as c_stats

    rng = np.random.RandomState(0)
    np.save(tmp_path / "latent_vectors_test_set_13l.npy", rng.rand(3, 4))
    np.save(tmp_path / "ae_loss_test_set_13l.npy", rng.rand(3))
    names = ["ae_loss_test_set", "latent_vectors_test_set"]
    for g, w in zip(c_art.load_data(str(tmp_path), None, names),
                    o_art.load_data(str(tmp_path), None, names)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        c_art.load_data(str(tmp_path), None, ["missing"])

    args = (["sphere", "cube"],
            *([rng.rand(4, 2).astype(np.float32) for _ in range(2)]
              for _ in range(5)))
    for writer, n_lists in (("write_attack_statistics_to_file", 5),
                            ("write_defense_statistics_to_file", 4),
                            ("write_transfer_statistics_to_file", 4)):
        outs = []
        for mod in (c_stats, o_stats):
            buf = io.StringIO()
            getattr(mod, writer)(buf, *args[:n_lists + 1])
            outs.append(buf.getvalue())
        assert outs[0] == outs[1], writer
    for data_type in ("target", "adversarial", "source", "before_defense",
                      "after_defense"):
        outs = []
        for mod in (c_stats, o_stats):
            buf = io.StringIO()
            mod.write_classification_statistics_to_file(buf, *args[:2], data_type)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1], data_type


@pytest.mark.parametrize("module,name", [
    ("defense.critical", "get_critical_points"),
    ("defense.critical", "_complementary_idx"),
    ("defense.critical", "get_critical_pc_non_critical_pc"),
    ("defense.surface", "get_outlier_pc_inlier_pc"),
    ("utils.stats", "write_attack_statistics_to_file"),
    ("utils.stats", "write_defense_statistics_to_file"),
    ("utils.stats", "write_transfer_statistics_to_file"),
    ("utils.stats", "write_classification_statistics_to_file"),
    ("data.synthetic", "_param_grid_faces"),
    ("data.synthetic", "_uv_grid"),
    ("data.synthetic", "shape_mesh_raw"),
    ("data.synthetic", "sample_shape_and_mesh"),
    ("data.synthetic", "make_dataset"),
    ("models.atlasnet", "sphere_template_points"),
    ("models.atlasnet", "square_template_points"),
    ("models.foldingnet", "folding_grid"),
    ("utils.artifacts", "artifact_name"),
    ("utils.artifacts", "save_artifact"),
    ("data.augment", "euler2mat"),
    ("classify.trainer", "jitter_point_cloud"),
    ("train.config", "_deep_copy_value"),
])
def test_numpy_copies_keep_their_originals_source(module, name):
    """The host-numpy copies are their originals' code, line for line, so
    that a change to one shows up here until the other follows."""
    import importlib
    import inspect

    orig = getattr(importlib.import_module(f"geometric_adv_tpu.{module}"), name)
    copy = getattr(importlib.import_module(f"geometric_adv_tpu_torch.{module}"), name)
    assert inspect.getsource(copy) == inspect.getsource(orig)


def test_meshable_classes_copy_matches_original():
    from geometric_adv_tpu.data import synthetic as orig
    from geometric_adv_tpu_torch.data import synthetic as copy

    assert copy.MESHABLE_CLASSES == orig.MESHABLE_CLASSES
