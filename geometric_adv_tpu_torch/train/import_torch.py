"""Import the reference's PyTorch transfer-AE checkpoints (AtlasNet,
FoldingNet) into the port's checkpoints (``geometric_adv_tpu/train/
import_torch.py``).

The reference ships AtlasNet as ``network.pth`` (the state dict of the
``nn.DataParallel``-wrapped EncoderDecoder, every key prefixed ``module.``:
``module.encoder.conv1.weight``, ``module.decoder.decoder.<k>.conv1.weight``,
reference: training/trainer_abstract.py:76-79) and FoldingNet as
``checkpoint_<epoch>.pth``, a dict ``{'epoch', 'model', 'optimizer'}`` of the
bare FoldingNet_graph (keys ``encoder.conv1.weight``,
``decoder.fold1.conv1.weight``; reference: transfer/foldingnet/
train_foldingnet.py:170-177).

The name mappings are numpy copies of the JAX package's: they build the
flax-layout tree (a ``Conv1d(k=1)``/``Linear`` weight ``[c_out, c_in(, 1)]``
becomes the Dense kernel ``[c_in, c_out]``; ``BatchNorm1d`` weight/bias ->
scale/bias and running_mean/var -> batch_stats, ``num_batches_tracked``
dropped), which ``models/bridge.py::state_dict_from_flax`` turns into the
port's ``models/{atlasnet,foldingnet}.py`` state dicts. The checkpoints are
written with ``train/checkpoint.py`` beside an ``arch.json``, so that
``tst_transfer`` / ``run_transfer --transfer_ae_restore_epoch`` rebuild the
module and restore it. Optimizer state is not imported.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
from geometric_adv_tpu_torch.train import checkpoint as ckpt
from geometric_adv_tpu_torch.transfer.trainers import save_transfer_arch


def load_torch_state_dict(path: str):
    """-> ({key: np.ndarray}, epoch | None). Strips any DataParallel prefix;
    reads with ``weights_only=True``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    epoch = None
    if isinstance(obj, dict) and "model" in obj:
        # FoldingNet-style checkpoint dict (train_foldingnet.py:170-177)
        epoch = int(obj["epoch"]) if "epoch" in obj else None
        obj = obj["model"]
    sd = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = np.asarray(v.detach().cpu().numpy())
    return sd, epoch


def _t_dense(sd, base):
    """torch Conv1d(k=1)/Linear -> flax Dense {kernel [c_in,c_out], bias}."""
    w = np.asarray(sd[f"{base}.weight"], np.float32)
    if w.ndim == 3:
        if w.shape[-1] != 1:
            raise ValueError(
                f"{base}.weight: filter size {w.shape[-1]} != 1 cannot map "
                "onto a per-point Dense layer"
            )
        w = w[:, :, 0]
    return {
        "kernel": np.ascontiguousarray(w.T),
        "bias": np.asarray(sd[f"{base}.bias"], np.float32),
    }


def _t_bn(sd, base):
    try:
        p = {
            "scale": np.asarray(sd[f"{base}.weight"], np.float32),
            "bias": np.asarray(sd[f"{base}.bias"], np.float32),
        }
        s = {
            "mean": np.asarray(sd[f"{base}.running_mean"], np.float32),
            "var": np.asarray(sd[f"{base}.running_var"], np.float32),
        }
    except KeyError as e:
        raise ValueError(f"{base}: incomplete BN variable set ({e})") from e
    return p, s


# --- AtlasNet ---------------------------------------------------------------


def map_reference_atlasnet_state(sd: dict[str, np.ndarray]):
    """-> (params, batch_stats, meta dict with the architecture hyperparams).

    meta carries what ``AtlasNetTrainer``/``AtlasNet`` need to rebuild the
    matching module: nb_primitives (ModuleList size), template_dim (first
    conv's fan-in: 3 SPHERE / 2 SQUARE), bottleneck_size, hidden_neurons,
    num_layers (conv_list length).
    """
    if "encoder.conv1.weight" not in sd:
        raise ValueError(
            "no encoder.conv1.weight — not a reference AtlasNet "
            f"EncoderDecoder state_dict (keys: {sorted(sd)[:6]}...)"
        )
    enc_p: dict = {}
    enc_s: dict = {}
    for i in (1, 2, 3):
        enc_p[f"conv{i}"] = _t_dense(sd, f"encoder.conv{i}")
    for i in (1, 2):
        enc_p[f"lin{i}"] = _t_dense(sd, f"encoder.lin{i}")
    for i in (1, 2, 3, 4, 5):
        enc_p[f"bn{i}"], enc_s[f"bn{i}"] = _t_bn(sd, f"encoder.bn{i}")

    prim_ids = sorted(
        {
            int(m.group(1))
            for k in sd
            for m in [re.match(r"decoder\.decoder\.(\d+)\.", k)]
            if m
        }
    )
    if prim_ids != list(range(len(prim_ids))) or not prim_ids:
        raise ValueError(f"unexpected decoder ModuleList indices: {prim_ids}")

    params: dict = {"encoder": enc_p}
    stats: dict = {"encoder": enc_s}
    num_layers = None
    for k in prim_ids:
        base = f"decoder.decoder.{k}"
        nl = len(
            {
                key
                for key in sd
                if re.match(rf"{re.escape(base)}\.conv_list\.\d+\.weight$", key)
            }
        )
        num_layers = nl if num_layers is None else num_layers
        if nl != num_layers:
            raise ValueError("primitives disagree on conv_list depth")
        p: dict = {
            "conv1": _t_dense(sd, f"{base}.conv1"),
            "conv2": _t_dense(sd, f"{base}.conv2"),
            "last_conv": _t_dense(sd, f"{base}.last_conv"),
        }
        s: dict = {}
        p["bn1"], s["bn1"] = _t_bn(sd, f"{base}.bn1")
        p["bn2"], s["bn2"] = _t_bn(sd, f"{base}.bn2")
        for i in range(nl):
            p[f"conv_list{i}"] = _t_dense(sd, f"{base}.conv_list.{i}")
            p[f"bn_list{i}"], s[f"bn_list{i}"] = _t_bn(
                sd, f"{base}.bn_list.{i}"
            )
        params[f"decoder_{k}"] = p
        stats[f"decoder_{k}"] = s

    first = params["decoder_0"]["conv1"]["kernel"]
    meta = {
        "nb_primitives": len(prim_ids),
        "template_dim": int(first.shape[0]),
        "bottleneck_size": int(first.shape[1]),
        "hidden_neurons": int(params["decoder_0"]["conv2"]["kernel"].shape[1]),
        "num_layers": int(num_layers),
    }
    return params, stats, meta


def import_reference_atlasnet_checkpoint(
    path: str, train_dir: str, epoch: int = 0
) -> tuple[str, int, dict]:
    """Convert a reference AtlasNet ``network.pth`` into the port's
    checkpoint of ``epoch`` (``network.pth`` carries none; default 0) and
    its ``arch.json``. -> (path, epoch, meta)."""
    sd, _ = load_torch_state_dict(path)
    params, batch_stats, meta = map_reference_atlasnet_state(sd)
    out = ckpt.save_checkpoint(train_dir, int(epoch),
                               state_dict_from_flax(params, batch_stats))
    save_transfer_arch(
        train_dir, "atlasnet", nb_primitives=meta["nb_primitives"],
        template_type="SPHERE" if meta["template_dim"] == 3 else "SQUARE")
    return out, int(epoch), meta


# --- FoldingNet -------------------------------------------------------------


def map_reference_foldingnet_state(sd: dict[str, np.ndarray]):
    """-> (params, batch_stats) in models/foldingnet.py's tree layout."""
    if "encoder.conv1.weight" not in sd or "decoder.fold1.conv1.weight" not in sd:
        raise ValueError(
            "not a reference FoldingNet_graph state_dict "
            f"(keys: {sorted(sd)[:6]}...)"
        )
    enc_p: dict = {}
    enc_s: dict = {}
    for i in (1, 2, 3, 4, 5):
        enc_p[f"conv{i}"] = _t_dense(sd, f"encoder.conv{i}")
    for i in (1, 2):
        enc_p[f"fc{i}"] = _t_dense(sd, f"encoder.fc{i}")
    for i in (1, 2, 3, 4, 5, 6):
        enc_p[f"bn{i}"], enc_s[f"bn{i}"] = _t_bn(sd, f"encoder.bn{i}")
    dec_p: dict = {}
    for fold in (1, 2):
        for i in (1, 2, 3):
            dec_p[f"fold{fold}_conv{i}"] = _t_dense(
                sd, f"decoder.fold{fold}.conv{i}"
            )
    return {"encoder": enc_p, "decoder": dec_p}, {"encoder": enc_s}


def import_reference_foldingnet_checkpoint(
    path: str, train_dir: str, epoch: int | None = None
) -> tuple[str, int]:
    """Convert a reference ``checkpoint_<epoch>.pth`` into the port's
    checkpoint and its ``arch.json``; the epoch defaults to the checkpoint
    dict's own counter. -> (path, epoch)."""
    sd, ckpt_epoch = load_torch_state_dict(path)
    params, batch_stats = map_reference_foldingnet_state(sd)
    epoch = epoch if epoch is not None else ckpt_epoch
    if epoch is None:
        raise ValueError(
            "checkpoint carries no epoch counter; pass epoch="
        )
    out = ckpt.save_checkpoint(train_dir, int(epoch),
                               state_dict_from_flax(params, batch_stats))
    save_transfer_arch(train_dir, "foldingnet")
    return out, int(epoch)
