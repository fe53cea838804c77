"""The port stands alone, and its copies of numpy-only modules stay equal to
their originals in the JAX package.

1. In a fresh interpreter where ``jax``, ``flax``, ``optax``, ``orbax`` and
   the JAX package itself cannot be imported, every module of
   ``geometric_adv_tpu_torch`` imports and the tiny slice runs through the
   stage CLIs on ``--device cpu``, from ``train_ae --loss emd`` on — as on a
   machine that has no JAX.
2. The copies (``attack/pipeline.py``, ``train/config.py`` and the data /
   augmentation / artifact helpers) give the originals' results on the same
   inputs.
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
for name in ("jax", "flax", "optax", "orbax", "geometric_adv_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
sys.path.insert(0, sys.argv[1])
import geometric_adv_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("cli.run_attack", "cli.train_ae", "ops.emd", "ops.cuda.emd",
             "ops.cuda.build", "train.trainer"):
    assert "geometric_adv_tpu_torch." + name in names, names

import numpy as np
from geometric_adv_tpu_torch.cli import (
    evaluate_attack, get_dists_per_point, prepare_indices_for_attack,
    run_attack, train_ae, tst_ae)
from geometric_adv_tpu_torch.data.synthetic import make_shapenet_like_dir

d, ae = sys.argv[2], "log/ae"
make_shapenet_like_dir(d + "/data/tiny", ["sphere", "cube", "torus"], 40, 64)
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
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and k.split(".")[0] in
                ("jax", "flax", "optax", "orbax", "geometric_adv_tpu"))
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
    with pytest.raises(NotImplementedError):
        resolve_device("cpu", matmul_precision="bfloat16")


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
    outs = []
    for mod in (c_stats, o_stats):
        buf = io.StringIO()
        mod.write_attack_statistics_to_file(buf, *args)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
