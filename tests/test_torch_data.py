"""The port's data layer against the JAX package's: the dataset functions
of geometric_adv_tpu_torch/data/datasets.py and the native PLY batch loader
(geometric_adv_tpu_torch/native/) against the python parser.

The copies are the originals' results on the same inputs (bit for bit:
nothing here computes in floating point beyond parsing) and, where the code
is the same, the originals' source line for line.
"""

import filecmp
import inspect
import os.path as osp

import numpy as np
import pytest

from geometric_adv_tpu.data import datasets as o_ds
from geometric_adv_tpu.data.ply import save_ply
from geometric_adv_tpu.data.synthetic import make_shapenet_like_dir
from geometric_adv_tpu_torch import native
from geometric_adv_tpu_torch.data import datasets as c_ds

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _native_or_skip():
    mod = native.get_module()
    if mod is None:
        pytest.skip(f"the native extension cannot be built here: {native.build_error}")
    return mod


@pytest.mark.parametrize("name", [
    "snc_category_to_synth_id", "split_data", "_pc_loader",
    "load_and_split_all_point_clouds_under_folder",
    "PointCloudDataSet.shuffle_points", "PointCloudDataSet.full_epoch_data",
    "PointCloudDataSet.merge",
])
def test_dataset_copies_keep_their_originals_source(name):
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    assert inspect.getsource(get(c_ds)) == inspect.getsource(get(o_ds))


def test_from_reference_txt_copy_keeps_its_originals_source_and_result(tmp_path):
    from geometric_adv_tpu.train.config import Configuration as Orig
    from geometric_adv_tpu_torch.train.config import Configuration as Copy

    assert (inspect.getsource(Copy.from_reference_txt)
            == inspect.getsource(Orig.from_reference_txt))
    txt = tmp_path / "configuration.txt"
    txt.write_text("".join("%30s: %s\n" % kv for kv in [
        ("n_input", [64, 3]), ("encoder_args", {"n_filters": [16, 32, 8], "b_norm": True,
                                                "b_norm_decay": 0.5}),
        ("decoder_args", {"layer_sizes": [32, 192]}), ("loss", "emd"),
        ("encoder", "encoder_with_convs_and_symmetry"), ("experiment_name", "run a"),
        ("z_rotate", False), ("unknown_key", 3)]))
    assert (Copy.from_reference_txt(str(txt)).to_dict()
            == Orig.from_reference_txt(str(txt)).to_dict())


def test_native_source_is_the_jax_packages_and_builds_under_build():
    assert filecmp.cmp(osp.join(REPO, "geometric_adv_tpu_torch/native/ply_loader.cpp"),
                       osp.join(REPO, "geometric_adv_tpu/native/ply_loader.cpp"),
                       shallow=False)
    assert native.so_path().parent == native.BUILD_DIR
    assert str(native.BUILD_DIR) == osp.join(REPO, "build", "native")
    _native_or_skip()
    assert native.so_path().exists()


def _write_tree(tmp_path, n_files=6, n_pts=50, binary=True, seed=0):
    rng = np.random.RandomState(seed)
    d = tmp_path / "class_a"
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n_files):
        p = str(d / f"model_{i}.ply")
        save_ply(p, rng.randn(n_pts, 3).astype(np.float32), binary=binary)
        paths.append(p)
    return paths


@pytest.mark.parametrize("binary", [True, False])
def test_native_loader_matches_python_parser_and_jax(tmp_path, binary):
    _native_or_skip()
    paths = _write_tree(tmp_path, binary=binary)
    before = dict(c_ds.LOADS)
    fast = c_ds.load_point_clouds_from_filenames(paths, n_threads=4)
    assert c_ds.LOADS == dict(before, native=before["native"] + 1)
    slow = c_ds.load_point_clouds_from_filenames(paths, use_native=False)
    assert c_ds.LOADS["python"] == before["python"] + 1
    want = o_ds.load_point_clouds_from_filenames(paths, use_native=False)
    for got in (fast, slow):
        # ascii text parses to the same float32 in both parsers
        np.testing.assert_array_equal(got[0], want[0])
        assert list(got[1]) == list(want[1]) == [f"model_{i}" for i in range(6)]
        assert list(got[2]) == list(want[2]) == ["class_a"] * 6
    custom = c_ds.load_point_clouds_from_filenames(paths, loader=c_ds._pc_loader)
    np.testing.assert_array_equal(custom[0], want[0])


def test_native_loader_error_paths(tmp_path):
    mod = _native_or_skip()
    with pytest.raises(ValueError):
        mod.load_file(str(tmp_path / "missing.ply"))
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError):
        mod.load_batch([str(bad)], 2)
    with pytest.raises(ValueError):
        mod.load_batch([], 2)


def test_load_and_split_on_a_shapenet_like_tree(tmp_path):
    """tests/test_data.py:96's tree: the port's split sets and load_dataset
    against the JAX package's."""
    root = make_shapenet_like_dir(str(tmp_path), class_names=("sphere", "cube"),
                                  n_per_class=10, n_points=64)
    got = c_ds.load_and_split_all_point_clouds_under_folder(root + "/sphere")
    want = o_ds.load_and_split_all_point_clouds_under_folder(root + "/sphere")
    assert [s.num_examples for s in got] == [9, 0, 1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.point_clouds, w.point_clouds)
        assert list(g.labels) == list(w.labels)
    pcs, slice_idx, labels = c_ds.load_dataset(["sphere", "cube"], "train_set", root)
    ds, w_slice, w_labels = o_ds.load_dataset(["sphere", "cube"], "train_set", root)
    np.testing.assert_array_equal(pcs, ds.point_clouds)
    assert slice_idx == w_slice == [0, 9, 18] and labels == w_labels
    assert c_ds.snc_category_to_synth_id() == o_ds.snc_category_to_synth_id()
    with pytest.raises(FileNotFoundError):
        c_ds.load_dataset(["torus"], "train_set", root)


def test_dataset_methods_match_jax():
    rng = np.random.RandomState(0)
    pcs = rng.randn(5, 16, 3).astype(np.float32)
    noise = pcs + 1.0
    labels = np.arange(5)
    a, b = (mod.PointCloudDataSet(pcs, noise=noise, labels=labels, init_shuffle=False)
            for mod in (c_ds, o_ds))
    for ds in (a, b):
        ds.shuffle_points(seed=1)
    for g, w in zip((a.point_clouds, a.noisy_point_clouds),
                    (b.point_clouds, b.noisy_point_clouds)):
        np.testing.assert_array_equal(g, w)
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=3)):
        for g, w in zip(a.full_epoch_data(**kw), b.full_epoch_data(**kw)):
            np.testing.assert_array_equal(g, w)
    a.next_batch(2)
    b.next_batch(2)
    other = rng.randn(3, 16, 3).astype(np.float32)
    a.merge(c_ds.PointCloudDataSet(other, noise=other, labels=np.arange(3),
                                   init_shuffle=False))
    b.merge(o_ds.PointCloudDataSet(other, noise=other, labels=np.arange(3),
                                   init_shuffle=False))
    assert a.num_examples == b.num_examples == 8
    assert a._index_in_epoch == b._index_in_epoch == 0
    for g, w in zip(a.full_epoch_data(shuffle=False), b.full_epoch_data(shuffle=False)):
        np.testing.assert_array_equal(g, w)
