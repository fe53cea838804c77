"""Import the reference's TF1 checkpoints into the port's checkpoints
(``geometric_adv_tpu/train/import_tf.py``).

The reference ships its pretrained victim and transfer PointNet AEs as
``tf.train.Saver`` V2 checkpoints (``models.ckpt-<epoch>``) and its PointNet
classifier as ``model-<epoch>.ckpt``. The name mappings here are numpy
copies of the JAX package's: they build the flax-layout tree
(``params``/``batch_stats``), which ``models/bridge.py::state_dict_from_flax``
turns into the port's state dict, so the layout has one definition. The
result is written with ``train/checkpoint.py::save_checkpoint`` with no
optimizer state (an imported checkpoint serves inference, the attack, the
defenses, transfer and fresh fine-tuning; ``AETrainer.restore`` and
``ClassifierTrainer.restore`` accept it).

Reference variable names (everything under the model-name scope,
src/pointnet_ae.py:35): ``<scope>/encoder_conv_layer_{i}/W`` ``[1, 1, c_in,
c_out]`` and ``/b``; ``<scope>/encoder_conv_layer_{i}_bnorm/{beta, gamma,
moving_mean, moving_variance}``; ``<scope>/decoder_fc_{i}/W`` ``[c_in,
c_out]`` and ``/b`` (an optional ``decoder_fc_{i}_bnorm``); ``<scope>/epoch``.
The classifier's names are described above ``_TNET_FINAL``. Adam's slot
variables are not imported.

Reading a checkpoint needs tensorflow's checkpoint reader, imported inside
``load_tf_variables`` only; the card's machine has no tensorflow, the
mappings need none.
"""

from __future__ import annotations

import re

import numpy as np

from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.train import checkpoint as ckpt

ENC_RE = re.compile(r"^(?P<scope>.+)/encoder_conv_layer_0/W$")


def load_tf_variables(ckpt_prefix: str) -> dict[str, np.ndarray]:
    """Every variable of a TF V2 checkpoint as {name: np.ndarray}.
    ``ckpt_prefix`` is the saver prefix, e.g. ``.../models.ckpt-500``."""
    try:
        from tensorflow.python.training import py_checkpoint_reader
    except ImportError as e:
        raise ImportError(
            "importing reference checkpoints needs the `tensorflow` package "
            "for its checkpoint reader (the rest of geometric_adv_tpu_torch "
            "does not use TF). Install tensorflow, or retrain with train_ae "
            "(see MIGRATION.md section 5)."
        ) from e

    reader = py_checkpoint_reader.NewCheckpointReader(ckpt_prefix)
    return {
        name: np.asarray(reader.get_tensor(name))
        for name in reader.get_variable_to_shape_map()
    }


def detect_model_scope(tf_vars: dict[str, np.ndarray]) -> str:
    """The reference model-name scope (e.g. ``autoencoder``, ``single_class_ae``)."""
    scopes = sorted(
        {m.group("scope") for name in tf_vars for m in [ENC_RE.match(name)] if m}
    )
    if not scopes:
        raise ValueError(
            "no <scope>/encoder_conv_layer_0/W variable found — not a "
            "reference PointNet-AE checkpoint (variables: "
            f"{sorted(tf_vars)[:8]}...)"
        )
    if len(scopes) > 1:
        raise ValueError(
            f"multiple AE scopes in checkpoint: {scopes}; pass ae_name="
        )
    return scopes[0]


def _dense_kernel(w: np.ndarray, name: str) -> np.ndarray:
    """tflearn conv/fc W -> flax Dense kernel [c_in, c_out]."""
    if w.ndim > 2:
        lead = w.shape[: w.ndim - 2]
        if int(np.prod(lead)) != 1:
            raise ValueError(
                f"{name}: expected unit filter dims, got shape {w.shape} "
                "(only filter_size-1 convs map onto per-point Dense layers)"
            )
        w = w.reshape(w.shape[-2:])
    if w.ndim != 2:
        raise ValueError(f"{name}: expected a matrix, got shape {w.shape}")
    return np.asarray(w, np.float32)


def _take_bn(tf_vars, scope_name):
    beta = tf_vars.get(f"{scope_name}/beta")
    if beta is None:
        return None, None
    gamma = tf_vars.get(f"{scope_name}/gamma")
    mean = tf_vars.get(f"{scope_name}/moving_mean")
    var = tf_vars.get(f"{scope_name}/moving_variance")
    if gamma is None or mean is None or var is None:
        raise ValueError(f"{scope_name}: incomplete BN variable set")
    bn_params = {
        "scale": np.asarray(gamma, np.float32),
        "bias": np.asarray(beta, np.float32),
    }
    bn_stats = {
        "mean": np.asarray(mean, np.float32),
        "var": np.asarray(var, np.float32),
    }
    return bn_params, bn_stats


def map_reference_ae_variables(
    tf_vars: dict[str, np.ndarray], ae_name: str | None = None
):
    """Reference AE variables -> (params, batch_stats, epoch | None).

    ``params``/``batch_stats`` have exactly the tree layout of
    ``PointNetAE.init`` (models/pointnet_ae.py): encoder Dense layers
    ``conv_{i}`` with BN ``bn_{i}``, decoder ``fc_{i}`` (BN only if the
    reference config had decoder b_norm on).
    """
    scope = ae_name or detect_model_scope(tf_vars)

    encoder_p: dict = {}
    encoder_s: dict = {}
    i = 0
    while f"{scope}/encoder_conv_layer_{i}/W" in tf_vars:
        base = f"{scope}/encoder_conv_layer_{i}"
        encoder_p[f"conv_{i}"] = {
            "kernel": _dense_kernel(tf_vars[f"{base}/W"], f"{base}/W"),
            "bias": np.asarray(tf_vars[f"{base}/b"], np.float32),
        }
        bn_p, bn_s = _take_bn(tf_vars, f"{base}_bnorm")
        if bn_p is not None:
            encoder_p[f"bn_{i}"] = bn_p
            encoder_s[f"bn_{i}"] = bn_s
        i += 1
    if i < 2:
        raise ValueError(
            f"found {i} encoder layers under scope '{scope}' — wrong scope? "
            "(pass ae_name= with the reference model's name)"
        )

    decoder_p: dict = {}
    decoder_s: dict = {}
    j = 0
    while f"{scope}/decoder_fc_{j}/W" in tf_vars:
        base = f"{scope}/decoder_fc_{j}"
        decoder_p[f"fc_{j}"] = {
            "kernel": _dense_kernel(tf_vars[f"{base}/W"], f"{base}/W"),
            "bias": np.asarray(tf_vars[f"{base}/b"], np.float32),
        }
        bn_p, bn_s = _take_bn(tf_vars, f"{base}_bnorm")
        if bn_p is not None:
            decoder_p[f"bn_{j}"] = bn_p
            decoder_s[f"bn_{j}"] = bn_s
        j += 1
    if j < 1:
        raise ValueError(f"no decoder_fc_* layers under scope '{scope}'")

    params = {"encoder": encoder_p, "decoder": decoder_p}
    batch_stats: dict = {}
    if encoder_s:
        batch_stats["encoder"] = encoder_s
    if decoder_s:
        batch_stats["decoder"] = decoder_s

    epoch = None
    if f"{scope}/epoch" in tf_vars:
        epoch = int(round(float(tf_vars[f"{scope}/epoch"])))
    return params, batch_stats, epoch


def _epoch_from_prefix(ckpt_prefix: str) -> int | None:
    # AE style ``models.ckpt-500`` and classifier style ``model-150.ckpt``
    # (reference: src/neural_net.py:10; classifier/train_classifier.py:200-203)
    m = re.search(r"-(\d+)(?:\.ckpt)?$", ckpt_prefix)
    return int(m.group(1)) if m else None


# --- PointNet classifier checkpoints ---------------------------------------
#
# The reference classifier (classifier/train_classifier.py, saved as
# ``model-<epoch>.ckpt``) builds its graph with classifier/tf_util.py:
#
# - ``<scope>/weights`` + ``/biases`` per conv2d/fully_connected layer
#   (tf_util.py:149-159,330-339); conv kernels are 4-D ([1,1,c_in,c_out],
#   or [1,3,1,64] for the first layer, which convolves the 3 coordinates —
#   both squeeze to the per-point Dense kernel [c_in, c_out]);
# - ``<scope>/bn/beta`` + ``/bn/gamma`` (batch_norm_template,
#   tf_util.py:454-500, epsilon 1e-3 — matched by models/pointnet_cls);
# - the moving statistics are ExponentialMovingAverage SHADOW variables of
#   the batch-moment tensors, created inside the bn scope with the full op
#   name, so the scope appears TWICE:
#   ``<scope>/bn/<scope>/bn/moments/Squeeze/ExponentialMovingAverage``
#   (mean) and ``.../Squeeze_1/ExponentialMovingAverage`` (variance)
#   (tf_util.py:473-477; ema.apply on tensors, zero_debias off);
# - T-Net scopes ``transform_net{1,2}/{tconv1..3,tfc1..2}`` with the final
#   regressor ``transform_XYZ`` (K=3) / ``transform_feat`` (K=64), whose
#   stored bias EXCLUDES the identity (added as a graph constant,
#   transform_nets.py:55-61,99-105 — same convention as the port's TNet).

_TNET_FINAL = {"transform_net1": "transform_XYZ", "transform_net2": "transform_feat"}


def _cls_dense(tf_vars, base):
    w = np.asarray(tf_vars[f"{base}/weights"], np.float32)
    w = np.squeeze(w) if w.ndim > 2 else w
    if w.ndim != 2:
        raise ValueError(f"{base}/weights: cannot squeeze {w.shape} to 2-D")
    return {
        "kernel": w,
        "bias": np.asarray(tf_vars[f"{base}/biases"], np.float32),
    }


def _cls_bn(tf_vars, base):
    bn = f"{base}/bn"
    shadow = f"{bn}/{bn}/moments"
    try:
        p = {
            "scale": np.asarray(tf_vars[f"{bn}/gamma"], np.float32),
            "bias": np.asarray(tf_vars[f"{bn}/beta"], np.float32),
        }
        s = {
            "mean": np.asarray(
                tf_vars[f"{shadow}/Squeeze/ExponentialMovingAverage"],
                np.float32,
            ),
            "var": np.asarray(
                tf_vars[f"{shadow}/Squeeze_1/ExponentialMovingAverage"],
                np.float32,
            ),
        }
    except KeyError as e:
        raise ValueError(f"{bn}: incomplete BN variable set ({e})") from e
    return p, s


def _map_tnet(tf_vars, scope):
    p: dict = {}
    s: dict = {}
    for i in (1, 2, 3):
        p[f"tconv{i}"] = _cls_dense(tf_vars, f"{scope}/tconv{i}")
        p[f"tbn{i}"], s[f"tbn{i}"] = _cls_bn(tf_vars, f"{scope}/tconv{i}")
    for i in (1, 2):
        p[f"tfc{i}"] = _cls_dense(tf_vars, f"{scope}/tfc{i}")
        p[f"tfc_bn{i}"], s[f"tfc_bn{i}"] = _cls_bn(tf_vars, f"{scope}/tfc{i}")
    p["transform"] = _cls_dense(tf_vars, f"{scope}/{_TNET_FINAL[scope]}")
    return p, s


def map_reference_classifier_variables(tf_vars: dict[str, np.ndarray]):
    """Reference PointNet-classifier variables -> (params, batch_stats).

    Handles both the full model (classifier/pointnet_cls.py, with T-Nets)
    and the basic variant (classifier/pointnet_cls_basic.py, detected by
    the absence of the transform_net scopes -> our ``use_tnets=False``).
    Tree layout matches ``PointNetClassifier.init`` (models/pointnet_cls.py).
    """
    if "conv1/weights" not in tf_vars:
        raise ValueError(
            "no conv1/weights variable — not a reference PointNet "
            f"classifier checkpoint (variables: {sorted(tf_vars)[:8]}...)"
        )
    params: dict = {}
    stats: dict = {}
    use_tnets = "transform_net1/tconv1/weights" in tf_vars
    if use_tnets:
        for scope in ("transform_net1", "transform_net2"):
            params[scope], stats[scope] = _map_tnet(tf_vars, scope)
    for i in (1, 2, 3, 4, 5):
        params[f"conv{i}"] = _cls_dense(tf_vars, f"conv{i}")
        params[f"conv{i}_bn"], stats[f"conv{i}_bn"] = _cls_bn(
            tf_vars, f"conv{i}"
        )
    for i in (1, 2):
        params[f"fc{i}"] = _cls_dense(tf_vars, f"fc{i}")
        params[f"fc{i}_bn"], stats[f"fc{i}_bn"] = _cls_bn(tf_vars, f"fc{i}")
    params["fc3"] = _cls_dense(tf_vars, "fc3")
    return params, stats, use_tnets


def import_reference_classifier_checkpoint(
    ckpt_prefix: str, train_dir: str, epoch: int | None = None
) -> tuple[str, int, int, bool]:
    """Convert a reference ``model-<epoch>.ckpt`` into the port's classifier
    checkpoint (``ClassifierTrainer.restore`` / the classifier CLIs'
    ``--restore_epoch``). -> (path, epoch, num_classes, use_tnets)."""
    tf_vars = load_tf_variables(ckpt_prefix)
    params, batch_stats, use_tnets = map_reference_classifier_variables(
        tf_vars
    )
    epoch = epoch if epoch is not None else _epoch_from_prefix(ckpt_prefix)
    if epoch is None:
        raise ValueError(
            "cannot infer the checkpoint epoch from the prefix; pass epoch="
        )
    num_classes = int(params["fc3"]["bias"].shape[0])
    path = ckpt.save_checkpoint(
        train_dir, int(epoch), state_dict_from_flax(params, batch_stats))
    return path, int(epoch), num_classes, use_tnets


def _check_against_conf(params, batch_stats, conf):
    """Shape-check the imported tree against a fresh victim for ``conf``."""
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    expected = {k: tuple(v.shape) for k, v in
                AETrainer(conf, "cpu").model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in
           state_dict_from_flax(params, batch_stats).items()}
    if got != expected:
        raise ValueError(
            "imported weights do not match the configuration's "
            f"architecture:\n  imported: {got}\n  expected: {expected}"
        )


def import_reference_checkpoint(
    ckpt_prefix: str,
    train_dir: str,
    ae_name: str | None = None,
    epoch: int | None = None,
    conf=None,
) -> tuple[str, int]:
    """Convert a reference AE checkpoint into the port's checkpoint of
    ``epoch`` under ``train_dir`` (``AETrainer.restore`` / the stages'
    ``--restore_epoch``). -> (path, epoch). The epoch defaults to the prefix's
    suffix (``models.ckpt-500`` -> 500), else the checkpoint's epoch
    variable; with ``conf`` the weights are shape-checked against that
    architecture before anything is written."""
    tf_vars = load_tf_variables(ckpt_prefix)
    params, batch_stats, ckpt_epoch = map_reference_ae_variables(
        tf_vars, ae_name
    )
    epoch = (
        epoch
        if epoch is not None
        else _epoch_from_prefix(ckpt_prefix) or ckpt_epoch
    )
    if epoch is None:
        raise ValueError(
            "cannot infer the checkpoint epoch (no -<N> prefix suffix and no "
            "epoch variable); pass epoch="
        )
    return write_reference_ae(params, batch_stats, train_dir, epoch, conf), int(epoch)


def write_reference_ae(params, batch_stats, train_dir: str, epoch: int,
                       conf=None) -> str:
    """Write a mapped victim tree as the port's checkpoint of ``epoch``
    (shape-checked against ``conf`` first where one is given)."""
    if conf is not None:
        _check_against_conf(params, batch_stats, conf)
    return ckpt.save_checkpoint(
        train_dir, int(epoch), state_dict_from_flax(params, batch_stats),
        opt_state=None)
