"""The paper's victim, the PointNet autoencoder, in plain PyTorch, float32.

Architecture (Achlioptas et al., ICML 2018, arXiv 1707.02392; the victim of
Lang et al., 3DV 2021, arXiv 2012.05657): a per-point MLP over the cloud
[b, n, 3] with widths ``encoder_filters``, each layer Dense -> batch norm ->
ReLU, then a max over the points gives the code z [b, bneck]; the decoder is
Dense layers ``decoder_sizes`` with ReLU between and a last linear layer of
n * 3 outputs, reshaped to [b, n, 3].

Batch norm is ``(x - mean) * (rsqrt(var + 1e-5) * scale) + shift`` over the
channel axis. In inference mode it uses the stored statistics; in training
mode the batch's, over every axis but the channel axis, with the variance
``mean(x^2) - mean(x)^2`` clipped at 0 (flax's batch norm, which the
reference's TensorFlow layers follow up to rounding).

Weights are a dict of tensors keyed ``encoder.conv_{i}.weight`` [out, in],
``encoder.conv_{i}.bias``, ``encoder.bn_{i}.{weight,bias,running_mean,
running_var}`` and ``decoder.fc_{i}.{weight,bias}``: the layout of the
weight file the benchmark makes, which it hands to both sides.
"""

from __future__ import annotations

import torch

EPS = 1e-5


def dense(x, w, prefix):
    return torch.matmul(x, w[prefix + ".weight"].t()) + w[prefix + ".bias"]


def batch_norm(x, w, prefix, train: bool):
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
    else:
        mean, var = w[prefix + ".running_mean"], w[prefix + ".running_var"]
    return (x - mean) * (torch.rsqrt(var + EPS) * w[prefix + ".weight"]) + w[prefix + ".bias"]


def encoder_layers(w) -> int:
    return sum(1 for k in w if k.startswith("encoder.conv_") and k.endswith(".weight"))


def decoder_layers(w) -> int:
    return sum(1 for k in w if k.startswith("decoder.fc_") and k.endswith(".weight"))


def encode(w, x, train: bool = False, stats: list | None = None):
    """[b, n, 3] -> z [b, bneck]. ``stats``, where given, collects each
    layer's batch (mean, variance) in training mode."""
    h = x
    for i in range(encoder_layers(w)):
        h = dense(h, w, f"encoder.conv_{i}")
        if stats is not None:
            axes = tuple(range(h.dim() - 1))
            mean = h.mean(dim=axes)
            stats.append((mean, torch.clamp((h * h).mean(dim=axes) - mean * mean, min=0.0)))
        h = torch.relu(batch_norm(h, w, f"encoder.bn_{i}", train))
    return h.amax(dim=-2)


def decode(w, z, n_points: int):
    h = z
    layers = decoder_layers(w)
    for i in range(layers):
        h = dense(h, w, f"decoder.fc_{i}")
        if i < layers - 1:
            h = torch.relu(h)
    return h.reshape(h.shape[:-1] + (n_points, 3))


@torch.no_grad()
def batch_statistics(w, x) -> list:
    """Each encoder layer's training-mode batch (mean, variance) on ``x``."""
    stats = []
    encode(w, x, train=True, stats=stats)
    return stats
