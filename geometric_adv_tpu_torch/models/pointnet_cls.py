"""PointNet classifier with input and feature T-Nets — the semantic evaluator.

Counterpart of ``geometric_adv_tpu/models/pointnet_cls.py`` (reference:
classifier/pointnet_cls.py:30-84, classifier/transform_nets.py:22-107): input
3x3 T-Net -> per-point Dense 64-64 -> feature 64x64 T-Net -> Dense
64-128-1024 -> max over points -> FC 512-256-num_classes with dropout (rate
0.3, kept units scaled by 1/0.7), batch norm everywhere but the logits.

Batch norm normalises with eps **1e-3**, the reference's hand-rolled BN
(classifier/tf_util.py:500; PARITY #12), not the 1e-5 of the AE side. Its
momentum is annealed during training (``classify.trainer``), which sets it
on every ``BatchNorm`` of the model before each step (``set_bn_momentum``).

Sub-module names follow the flax ones (``transform_net1.tconv1``,
``conv1_bn``, ``fc3``) so that ``models/bridge.py`` maps the trees one to
one. In train mode the caller gives the dropout masks, drawn from an
explicit ``torch.Generator`` (``draw_dropout_masks``) or, in the tests,
the JAX package's.
"""

from __future__ import annotations

import torch
from torch import nn

from geometric_adv_tpu_torch.models.layers import BatchNorm
from geometric_adv_tpu_torch.models.pointnet_ae import init_weights

BN_EPS = 1e-3  # reference: classifier/tf_util.py:500
KEEP_PROB = 0.7  # reference: classifier/pointnet_cls.py:78-82
DROPOUT_WIDTHS = (512, 256)  # the units of the two dropout layers


def _add_dense_bn(owner: nn.Module, name: str, bn_name: str, fan_in: int,
                  width: int, momentum: float) -> None:
    owner.add_module(name, nn.Linear(fan_in, width))
    owner.add_module(bn_name, BatchNorm(width, eps=BN_EPS, momentum=momentum))


def _dense_bn(owner: nn.Module, name: str, bn_name: str,
              x: torch.Tensor) -> torch.Tensor:
    return torch.relu(getattr(owner, bn_name)(getattr(owner, name)(x)))


class TNet(nn.Module):
    """Spatial/feature transform regressor -> [b, k, k]. Its last Dense
    starts at zero (``zero_transform``) and the identity is added to its
    output, so the net starts as the identity
    (reference: transform_nets.py:51-63, 95-106)."""

    def __init__(self, k: int, in_features: int, bn_momentum: float = 0.9):
        super().__init__()
        self.k = k
        for i, (fan_in, width) in enumerate(((in_features, 64), (64, 128),
                                             (128, 1024))):
            _add_dense_bn(self, f"tconv{i + 1}", f"tbn{i + 1}", fan_in, width,
                          bn_momentum)
        for i, (fan_in, width) in enumerate(((1024, 512), (512, 256))):
            _add_dense_bn(self, f"tfc{i + 1}", f"tfc_bn{i + 1}", fan_in, width,
                          bn_momentum)
        self.transform = nn.Linear(256, k * k)

    def zero_transform(self) -> None:
        with torch.no_grad():
            self.transform.weight.zero_()
            self.transform.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = _dense_bn(self, f"tconv{i + 1}", f"tbn{i + 1}", x)
        x = x.amax(dim=-2)  # max over points
        for i in range(2):
            x = _dense_bn(self, f"tfc{i + 1}", f"tfc_bn{i + 1}", x)
        x = self.transform(x)
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(-1)
        return (x + eye).reshape(x.shape[:-1] + (self.k, self.k))


class PointNetClassifier(nn.Module):
    """Full PointNet classifier (reference: classifier/pointnet_cls.py:30-84);
    ``use_tnets=False`` is the "basic" variant without the transform nets
    (reference: classifier/pointnet_cls_basic.py), whose feature transform is
    the identity and its regulariser zero."""

    def __init__(self, num_classes: int = 13, bn_momentum: float = 0.9,
                 use_tnets: bool = True):
        super().__init__()
        self.use_tnets = use_tnets
        if use_tnets:
            self.transform_net1 = TNet(3, 3, bn_momentum)
        _add_dense_bn(self, "conv1", "conv1_bn", 3, 64, bn_momentum)
        _add_dense_bn(self, "conv2", "conv2_bn", 64, 64, bn_momentum)
        if use_tnets:
            self.transform_net2 = TNet(64, 64, bn_momentum)
        for name, fan_in, width in (("conv3", 64, 64), ("conv4", 64, 128),
                                    ("conv5", 128, 1024), ("fc1", 1024, 512),
                                    ("fc2", 512, 256)):
            _add_dense_bn(self, name, name + "_bn", fan_in, width, bn_momentum)
        self.fc3 = nn.Linear(256, num_classes)

    @staticmethod
    def _dropout(x, mask):
        if mask is None:
            return x
        # as flax's Dropout: kept units divided by the keep probability
        return torch.where(mask, x / KEEP_PROB, torch.zeros_like(x))

    def forward(self, x: torch.Tensor, dropout_masks=None):
        """[b, n, 3] -> (logits [b, num_classes], feature transform
        [b, 64, 64]). Train mode takes the two dropout layers' keep masks,
        [b, 512] and [b, 256] bool (``draw_dropout_masks``); eval mode uses
        none."""
        if not self.training:
            dropout_masks = (None, None)
        elif dropout_masks is None:
            raise ValueError("train mode needs the dropout keep masks")
        if self.use_tnets:
            x = torch.matmul(x, self.transform_net1(x))
        x = _dense_bn(self, "conv1", "conv1_bn", x)
        x = _dense_bn(self, "conv2", "conv2_bn", x)
        if self.use_tnets:
            t_feat = self.transform_net2(x)
            x = torch.matmul(x, t_feat)
        else:
            t_feat = torch.eye(64, dtype=x.dtype, device=x.device).expand(
                x.shape[:-2] + (64, 64))
        for name in ("conv3", "conv4", "conv5"):
            x = _dense_bn(self, name, name + "_bn", x)
        x = x.amax(dim=-2)  # global max pool
        x = self._dropout(_dense_bn(self, "fc1", "fc1_bn", x), dropout_masks[0])
        x = self._dropout(_dense_bn(self, "fc2", "fc2_bn", x), dropout_masks[1])
        return self.fc3(x), t_feat


def draw_dropout_masks(batch: int, generator: torch.Generator | None, device):
    """The two layers' keep masks, Bernoulli(KEEP_PROB) per unit."""
    return tuple(torch.rand((batch, w), generator=generator, device=device) < KEEP_PROB
                 for w in DROPOUT_WIDTHS)


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """Set the momentum of every ``BatchNorm`` in ``model``, T-Nets included."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.momentum = momentum


def init_classifier_weights(model: PointNetClassifier,
                            generator: torch.Generator) -> PointNetClassifier:
    """``init_weights`` (flax's default Dense init), then each T-Net's last
    Dense at zero (flax's zeros kernel and bias initialisers)."""
    init_weights(model, generator)
    for module in model.modules():
        if isinstance(module, TNet):
            module.zero_transform()
    return model


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor,
                    transform: torch.Tensor, reg_weight: float = 0.001):
    """Softmax CE + reg_weight * l2_loss(T T^T - I), TF's l2_loss being
    sum(x^2)/2 (reference: classifier/pointnet_cls.py:87-102)."""
    log_probs = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(log_probs, -1, labels.long()[:, None]).mean()
    k = transform.shape[-1]
    diff = (torch.matmul(transform, transform.transpose(-1, -2))
            - torch.eye(k, dtype=transform.dtype, device=transform.device))
    mat_loss = 0.5 * torch.sum(diff * diff)
    return ce + reg_weight * mat_loss
