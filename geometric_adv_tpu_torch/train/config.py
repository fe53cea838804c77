"""Experiment configuration — a copy of ``geometric_adv_tpu/train/config.py``.

The JAX package's ``geometric_adv_tpu.train`` imports jax, flax and optax
from its ``__init__``, so the port keeps its own copy of this pure
numpy/json dataclass, in the same ``configuration.json`` schema: either
package loads what the other saved (pinned by ``tests/test_torch_imports.py``).
``default_train_params`` and ``from_reference_txt`` (the reference-checkpoint
importer's ``--reference_config``) are copied too, as are the helpers no
stage calls: ``copy``, ``exists_and_is_not_none`` and ``resolved_n_output``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Configuration:
    # --- core AE parameters (reference: src/autoencoder.py:26-33) ---
    n_input: list = field(default_factory=lambda: [2048, 3])
    n_output: list | None = None
    is_denoising: bool = False
    loss: str = "chamfer"  # {chamfer, emd}
    bneck_size: int = 128
    encoder_filters: list | None = None  # None -> [64,128,128,256,bneck]
    decoder_sizes: list | None = None  # None -> [256,256] (+ n*3 out layer)
    b_norm_decay: float = 0.9  # BN moving-stat momentum; 1.0 freezes stats
    ae_dtype: str = "float32"  # compute dtype; "bfloat16" trades ~1e-3
    #   metric drift for ~13% attack throughput (losses stay f32)

    # --- training (reference: src/autoencoder.py:35-45, ae_templates.py:42-51)
    training_epochs: int = 500
    batch_size: int = 50
    learning_rate: float = 0.0005
    loss_display_step: int = 1
    saver_step: int | None = 50
    saver_max_to_keep: int | None = None
    held_out_step: int | None = 5
    train_dir: str | None = None
    gauss_augment: dict | None = None
    z_rotate: bool = False
    debug: bool = False
    n_z: int | None = None
    latent_vs_recon: float = 1.0
    consistent_io: bool | None = None
    exponential_decay: bool = False
    decay_steps: int | None = None  # in EPOCHS (reference keys on the epoch
    #   counter, src/pointnet_ae.py:93-95); requires steps_per_epoch
    steps_per_epoch: int | None = None
    scan_epochs: bool = True  # False: host per-step loop (numpy RNG
    #   augmentations) — an escape hatch / host-parity test path; True runs
    #   each epoch as one device program incl. augmentations (device_augment)

    # --- experiment identity (reference: autoencoder/train_ae.py:43-77) ---
    experiment_name: str = "autoencoder"
    object_class: list = field(default_factory=lambda: ["13l"])
    class_names: list = field(
        default_factory=lambda: [
            "table", "car", "chair", "airplane", "sofa", "rifle", "lamp",
            "watercraft", "bench", "loudspeaker", "cabinet", "display",
            "telephone",
        ]
    )
    sort_axes: bool = True

    # --- attack stage (reference: attacker/run_attack.py:83-107) ---
    ae_dir: str | None = None
    ae_name: str | None = None
    ae_restore_epoch: int | None = None
    loss_adv_type: str = "chamfer"  # {latent, chamfer}
    loss_dist_type: str = "chamfer"  # {pert, chamfer}
    dist_weight_list: list = field(default_factory=lambda: [1.0])
    max_point_pert_weight: float = 0.0
    max_point_dist_weight: float = 0.0
    target_pc_idx_type: str = "chamfer_nn_complete"
    num_pc_for_attack: int = 25
    num_pc_for_target: int = 5
    correct_pred_only: bool = False
    num_iterations: int = 500
    num_iterations_thresh: int = 400
    chamfer_refresh: int = 0  # >0: frozen-assignment chamfer fast mode —
    #   NN assignments recomputed exactly every N attack iterations, held
    #   frozen (pure elementwise loss+grad) in between; 0 = exact every
    #   step (parity default). See attack/core.py::attack_batch, PARITY #13

    # --- defense stage (reference: defender/run_defense_*.py) ---
    defense_type: str | None = None  # {critical, surface}
    knn_dist_thresh: float | None = None
    num_knn: int | None = None

    # free-form extensions, preserved across save/load
    extra: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    def exists_and_is_not_none(self, attribute: str) -> bool:
        """reference: src/autoencoder.py:59-60."""
        return getattr(self, attribute, None) is not None

    def copy(self) -> "Configuration":
        return dataclasses.replace(
            self,
            **{
                f.name: _deep_copy_value(getattr(self, f.name))
                for f in dataclasses.fields(self)
            },
        )

    @property
    def n_points(self) -> int:
        return self.n_input[0]

    def resolved_n_output(self) -> list:
        return self.n_output if self.n_output is not None else self.n_input

    # --- serialization -------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Configuration":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        unknown = {k: v for k, v in d.items() if k not in known}
        conf = cls(**kwargs)
        if unknown:
            conf.extra.update(unknown)
        return conf

    def __str__(self) -> str:
        # Sorted key: value dump, one per line — the same human-readable
        # format as the reference (src/autoencoder.py:62-73).
        lines = []
        for key in sorted(self.to_dict()):
            lines.append("%30s: %s" % (key, getattr(self, key)))
        return "\n".join(lines) + "\n"

    def save(self, file_name: str) -> None:
        """Write ``<file_name>.json`` + human-readable ``<file_name>.txt``
        (reference: src/autoencoder.py:75-78)."""
        os.makedirs(os.path.dirname(os.path.abspath(file_name)), exist_ok=True)
        with open(file_name + ".json", "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)
        with open(file_name + ".txt", "w") as f:
            f.write(str(self))

    @staticmethod
    def load(file_name: str) -> "Configuration":
        with open(file_name + ".json") as f:
            return Configuration.from_dict(json.load(f))

    @classmethod
    def from_reference_txt(cls, path: str) -> "Configuration":
        """Import a reference experiment's configuration from its .txt dump.

        The reference pickles its ``Configuration`` with live TF function
        references (reference: src/autoencoder.py:75-78) — unloadable outside
        TF1 — but writes a sorted human-readable ``<name>.txt`` next to the
        pickle (``"%30s: %s" % (key, value)`` per line, callables dumped by
        ``__name__``). This parses that dump so a reference ``log/`` tree's
        experiment settings carry over directly (architecture, loss,
        training/attack hyperparameters); see MIGRATION.md.

        Field translation: the reference encodes the architecture in
        ``encoder_args['n_filters']`` / ``decoder_args['layer_sizes']``
        (reference: src/ae_templates.py:22-33) — mapped to
        ``encoder_filters``/``bneck_size``/``decoder_sizes`` here (the
        decoder's final ``n*3`` linear layer is implicit in this framework).
        Graph-building keys with no equivalent (encoder/decoder function
        names, tflearn arg dicts) are preserved in ``extra``.
        """
        import ast
        import re

        raw: dict[str, Any] = {}
        with open(path) as f:
            for line in f:
                m = re.match(r"\s*([A-Za-z_][A-Za-z0-9_]*): (.*)$", line)
                if not m:
                    continue
                key, val = m.group(1), m.group(2).strip()
                try:
                    raw[key] = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    raw[key] = val  # function names, paths, free-form strings

        d: dict[str, Any] = {}
        enc_args = raw.pop("encoder_args", None)
        if isinstance(enc_args, dict):
            n_filters = enc_args.get("n_filters")
            if n_filters:
                d["encoder_filters"] = list(n_filters)
                d["bneck_size"] = int(n_filters[-1])
            if "b_norm_decay" in enc_args:
                d["b_norm_decay"] = float(enc_args["b_norm_decay"])
            d.setdefault("extra", {})["reference_encoder_args"] = enc_args
        dec_args = raw.pop("decoder_args", None)
        if isinstance(dec_args, dict):
            layer_sizes = dec_args.get("layer_sizes")
            if layer_sizes:
                # the reference's last FC layer IS the n*3 output layer
                d["decoder_sizes"] = list(layer_sizes[:-1])
            d.setdefault("extra", {})["reference_decoder_args"] = dec_args
        for fn_key in ("encoder", "decoder"):
            if fn_key in raw:
                d.setdefault("extra", {})[f"reference_{fn_key}"] = raw.pop(
                    fn_key
                )

        d.update(raw)  # shared field names map 1:1 (n_input, loss, batch_size,
        # learning_rate, training_epochs, z_rotate, gauss_augment, attack keys
        # like loss_adv_type/dist_weight_list/num_iterations, ...)
        extra = d.pop("extra", {})
        conf = cls.from_dict(d)
        conf.extra.update(extra)
        return conf


def _deep_copy_value(v):
    if isinstance(v, dict):
        return {k: _deep_copy_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_deep_copy_value(x) for x in v]
    return v


def default_train_params() -> dict:
    """reference: src/ae_templates.py:42-51."""
    return {
        "batch_size": 50,
        "training_epochs": 500,
        "denoising": False,
        "learning_rate": 0.0005,
        "z_rotate": False,
        "saver_step": 50,
        "loss_display_step": 1,
    }
