"""ShapeNetCore-layout loading and the deterministic 85/5/10 split.

The loading half of ``geometric_adv_tpu/data/datasets.py`` (reference:
src/in_out.py:12-218), with the same file order, the same seed-42 split with
round-half-up boundaries and the same class concatenation, so the same
examples land in the same sets (pinned by ``tests/test_torch_imports.py``).
``load_dataset`` returns the arrays. ``PointCloudDataSet`` is the in-memory
set that AE training shuffles and batches, a copy of the original's.

Files are parsed by the native C++ batch loader (``native/``, built with the
host g++ on first use) where it can be had, else by the pure-python
``data/ply.py`` in a thread pool, as in the JAX package.
``LOADS`` counts the calls each path served, so a caller can tell which ran.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from geometric_adv_tpu_torch.data.ply import load_ply

# reference: src/in_out.py:12-32 (public ShapeNetCore synset table)
snc_synth_id_to_category = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02834778": "bicycle", "02843684": "birdhouse", "02871439": "bookshelf",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "trash_bin", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "display",
    "04379243": "table", "04401088": "telephone", "02946921": "can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file_cabinet",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "loudspeaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwaves", "03790512": "motorbike", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "flowerpot", "04004475": "printer", "04074963": "remote",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "watercraft",
    "04554684": "washer", "02858304": "boat", "02992529": "cellphone",
}


def create_dir(dir_path: str) -> str:
    os.makedirs(dir_path, exist_ok=True)
    return dir_path


def files_in_subdirs(top_dir: str, search_pattern: str):
    regex = re.compile(search_pattern)
    for path, _, files in os.walk(top_dir):
        for name in files:
            full_name = osp.join(path, name)
            if regex.search(full_name):
                yield full_name


def snc_category_to_synth_id() -> dict[str, str]:
    return {v: k for k, v in snc_synth_id_to_category.items()}


def split_data(data, split=(0.85, 0.05, 0.10), seed=42, perm=None):
    """Deterministic split — exact reference semantics
    (reference: src/in_out.py:194-218): seeded shuffle then round-half-up
    boundaries, so the same files land in the same train/val/test sets."""
    assert abs(sum(split) - 1.0) < 1e-9, "data split does not sum to 1"
    num_examples = data.shape[0]
    if perm is None:
        if seed is not None:
            np.random.seed(seed)
        perm = np.arange(num_examples)
        np.random.shuffle(perm)
    data = data[perm]
    train_end = int(split[0] * num_examples + 0.5)
    val_end = int((split[0] + split[1]) * num_examples + 0.5)
    return data[:train_end], data[train_end:val_end], data[val_end:], perm


def load_point_clouds_under_folder(top_dir, n_threads=8, file_ending=".ply"):
    """[N, n, 3] clouds of every file under ``top_dir``, in sorted order."""
    file_names = sorted(files_in_subdirs(top_dir, file_ending))
    if not file_names:
        raise FileNotFoundError(f"no {file_ending} files under {top_dir}")
    return load_point_clouds_from_filenames(file_names, n_threads)[0]


LOADS = {"native": 0, "python": 0}  # calls served by each parsing path


def _names(file_names):
    """(model names, class ids) of ``/syn_id/model_name.ply`` paths."""
    model_names = np.empty(len(file_names), dtype=object)
    class_ids = np.empty(len(file_names), dtype=object)
    for i, f_name in enumerate(file_names):
        tokens = f_name.split("/")
        model_names[i] = tokens[-1].split(".")[0]
        class_ids[i] = tokens[-2]
    return model_names, class_ids


def load_point_clouds_from_filenames(
    file_names, n_threads=8, loader=None, use_native=True
):
    """Parallel bulk load (reference: src/in_out.py:172-191) ->
    (clouds [N, n, 3] float32, model names, class ids). The native batch
    loader parses every file into one buffer with a thread pool; a custom
    ``loader``, ``use_native=False`` or an unavailable extension take the
    python parser in a thread pool instead."""
    if loader is None and use_native:
        from geometric_adv_tpu_torch.native import get_module

        native = get_module()
        if native is not None:
            buf, n_files, n_vertex = native.load_batch(
                list(file_names), int(n_threads)
            )
            pclouds = np.frombuffer(buf, dtype=np.float32).reshape(
                n_files, n_vertex, 3
            ).copy()
            LOADS["native"] += 1
            return (pclouds, *_names(file_names))

    loader = loader or _pc_loader
    first_pc = loader(file_names[0])[0]
    pclouds = np.empty(
        (len(file_names),) + first_pc.shape, dtype=np.float32
    )
    model_names = np.empty(len(file_names), dtype=object)
    class_ids = np.empty(len(file_names), dtype=object)
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        for i, (pc, model_id, syn_id) in enumerate(
            pool.map(loader, file_names)
        ):
            pclouds[i] = pc
            model_names[i] = model_id
            class_ids[i] = syn_id
    LOADS["python"] += 1
    return pclouds, model_names, class_ids


def _pc_loader(f_name: str):
    """reference: src/in_out.py:102-109 — /syn_id/model_name.ply scheme."""
    tokens = f_name.split("/")
    model_id = tokens[-1].split(".")[0]
    synset_id = tokens[-2]
    return load_ply(f_name), model_id, synset_id


def load_and_split_all_point_clouds_under_folder(
    top_dir, n_threads=8, file_ending=".ply", split=(0.85, 0.05, 0.10), seed=42
):
    file_names = sorted(files_in_subdirs(top_dir, file_ending))
    pclouds, model_ids, syn_ids = load_point_clouds_from_filenames(
        file_names, n_threads
    )
    tr, va, te, perm = split_data(pclouds, split, seed)
    mtr, mva, mte, _ = split_data(model_ids, split, seed, perm)
    str_, sva, ste, _ = split_data(syn_ids, split, seed, perm)
    mk = lambda pcs, syn, mod: PointCloudDataSet(  # noqa: E731
        pcs,
        labels=np.array([f"{s}_{m}" for s, m in zip(syn, mod)], dtype=object),
        init_shuffle=False,
    )
    return mk(tr, str_, mtr), mk(va, sva, mva), mk(te, ste, mte)


def load_dataset(class_names, set_type, input_dir, n_threads=8):
    """Concatenate per-class split sets; returns (point_clouds [N, n, 3],
    slice_idx, labels) (reference: src/in_out.py:112-147)."""
    assert set_type in ("train_set", "val_set", "test_set")
    set_pos = {"train_set": 0, "val_set": 1, "test_set": 2}[set_type]
    cat2id = snc_category_to_synth_id()

    parts = []
    slice_idx = [0]
    pc_label: list[int] = []
    for i, name in enumerate(class_names):
        class_dir = osp.join(input_dir, cat2id.get(name, name))
        if not any(files_in_subdirs(class_dir, ".ply")):
            raise FileNotFoundError(f"no .ply files under {class_dir}")
        cur = load_and_split_all_point_clouds_under_folder(
            class_dir, n_threads=n_threads
        )[set_pos].point_clouds
        parts.append(cur)
        slice_idx.append(slice_idx[-1] + len(cur))
        pc_label += [i] * len(cur)
    return np.vstack(parts), slice_idx, pc_label


class PointCloudDataSet:
    """In-memory dataset with epoch/batch iteration
    (reference: src/in_out.py:221-338)."""

    def __init__(
        self, point_clouds, noise=None, labels=None, copy=True,
        init_shuffle=True,
    ):
        self.num_examples = point_clouds.shape[0]
        self.n_points = point_clouds.shape[1]

        if labels is not None:
            assert point_clouds.shape[0] == labels.shape[0]
            self.labels = labels.copy() if copy else labels
        else:
            self.labels = np.ones(self.num_examples, dtype=np.int8)

        if noise is not None:
            self.noisy_point_clouds = noise.copy() if copy else noise
        else:
            self.noisy_point_clouds = None

        self.point_clouds = point_clouds.copy() if copy else point_clouds
        self.epochs_completed = 0
        self._index_in_epoch = 0
        if init_shuffle:
            self.shuffle_data()

    def shuffle_data(self, seed=None):
        if seed is not None:
            np.random.seed(seed)
        perm = np.arange(self.num_examples)
        np.random.shuffle(perm)
        self.point_clouds = self.point_clouds[perm]
        self.labels = self.labels[perm]
        if self.noisy_point_clouds is not None:
            self.noisy_point_clouds = self.noisy_point_clouds[perm]
        return self

    def shuffle_points(self, seed=None):
        """Shuffle point order within each cloud
        (reference: src/in_out.py:277-287)."""
        if seed is not None:
            np.random.seed(seed)
        perm = np.arange(self.n_points)
        for i in range(self.num_examples):
            np.random.shuffle(perm)
            self.point_clouds[i] = self.point_clouds[i, perm, :]
            if self.noisy_point_clouds is not None:
                self.noisy_point_clouds[i] = self.noisy_point_clouds[i, perm, :]
        return self

    def next_batch(self, batch_size, shuffle=True, seed=None):
        start = self._index_in_epoch
        self._index_in_epoch += batch_size
        if self._index_in_epoch > self.num_examples:
            self.epochs_completed += 1
            if shuffle:
                self.shuffle_data(seed)
            start = 0
            self._index_in_epoch = batch_size
        end = self._index_in_epoch
        noise = (
            None
            if self.noisy_point_clouds is None
            else self.noisy_point_clouds[start:end]
        )
        return self.point_clouds[start:end], self.labels[start:end], noise

    def full_epoch_data(self, shuffle=True, seed=None):
        if shuffle and seed is not None:
            np.random.seed(seed)
        perm = np.arange(self.num_examples)
        if shuffle:
            np.random.shuffle(perm)
        ns = (
            None
            if self.noisy_point_clouds is None
            else self.noisy_point_clouds[perm]
        )
        return self.point_clouds[perm], self.labels[perm], ns

    def merge(self, other):
        self._index_in_epoch = 0
        self.epochs_completed = 0
        self.point_clouds = np.vstack(
            (self.point_clouds, other.point_clouds)
        )
        self.labels = np.concatenate((self.labels, other.labels))
        if self.noisy_point_clouds is not None:
            self.noisy_point_clouds = np.vstack(
                (self.noisy_point_clouds, other.noisy_point_clouds)
            )
        self.num_examples = self.point_clouds.shape[0]
        return self
