"""Shared building blocks for the point-cloud models.

Counterparts of ``geometric_adv_tpu/models/layers.py``'s ``PointMLP``,
``ConvUpsampleDecoder`` and ``FCStack``. Layout stays ``[b, n, c]`` at every
public function: a k=1 conv over points is a ``Dense`` (an ``nn.Linear``) on
the channel axis. Sub-module names follow the flax ones (``conv_{i}``,
``bn_{i}``, ``fc_{i}``) so the weight bridge (``models/bridge.py``) maps the
trees one to one.

``dtype`` is flax's compute dtype: parameters and BN statistics stay
float32; a bfloat16 ``Dense`` casts its input, kernel and bias to bfloat16,
rounds the product to bfloat16 and adds the bias in bfloat16, and a
bfloat16 ``BatchNorm`` normalises in float32 and rounds its output to
bfloat16 (flax 0.12's ``Dense`` and ``_normalize``, statistics reduced in
float32 as its ``force_float32_reductions``). At float32 both are the plain
float32 layers.

Batch norm follows flax 0.12's ``nn.BatchNorm``: in eval mode it uses its
running statistics, which is how the attack and eval stages run the victim
(frozen stats, reference: attacker/run_attack.py:88-90); in train mode it
normalises with the batch statistics and updates the running ones.

Under a mesh of several processes (``set_batch_norm_mesh``, which the AE
trainer calls), each rank holds its rows of the batch and train mode takes
the statistics over the global batch, as GSPMD does for flax's batch norm on
a batch-sharded array: one differentiable all-reduce sums every rank's
``sum(x)`` and ``sum(x*x)``, and both divide by the global count.

``PointMLP`` runs each layer's batch norm and the ReLU after it through
``bn_relu``: in train mode, on one process, at float32, on a CUDA input it
is one op with hand-written kernels (``ops/bn_relu.py``: the
batch moments as here, then one launch forward and two backward), equal
to the composed version bit for bit forward; everywhere else it is
``torch.relu(bn(x))``.

``PointMLP`` and ``FCStack``, the victim's encoder and decoder, replay
their train-mode step as CUDA graphs where ``takes_body_graph`` holds
(``models/body_graph.py``): in train mode with grad enabled, on a
contiguous float32 CUDA input, on one process (no mesh), every layer at
float32 (the encoder's every batch norm on the fused route), no hook on a
layer. Everywhere else, and for a key's first two sightings, they run the
layers eager.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from geometric_adv_tpu_torch.models.body_graph import BodyGraphs
from geometric_adv_tpu_torch.ops.bn_relu import batch_moments, bn_relu_train, update_running
from geometric_adv_tpu_torch.parallel.distributed import differentiable_all_reduce_sum


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name ("float32", "bfloat16";
    None is float32); ValueError on any other."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if (dtype or "float32") not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[dtype or "float32"]


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """Batch norm over the last (channel) axis in flax's formula
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` with eps 1e-5.

    Train mode takes the statistics over every axis but the channel axis,
    with flax's fast variance ``mean(x^2) - mean(x)^2`` clipped at 0 (the
    biased variance); gradients flow through both. It then updates the
    running statistics as ``momentum * running + (1 - momentum) * batch``
    (flax's ``momentum``, the reference's ``b_norm_decay``), the biased
    variance included: ``torch.nn.functional.batch_norm`` would weight the
    other way and store the unbiased variance.

    ``mesh`` (None: one process) makes train mode's statistics those of the
    global batch, every rank holding an equal share of its rows.
    """

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = compute_dtype(dtype)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype != torch.float32:
            return self._forward_f32(x.float()).to(self.dtype)
        return self._forward_f32(x)

    def _forward_f32(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if self.mesh is None:
                mean, mean_sq = batch_moments(x)
            else:
                axes = tuple(range(x.dim() - 1))
                sums = differentiable_all_reduce_sum(
                    torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes)]), self.mesh)
                count = x.numel() // x.shape[-1] * self.mesh.size
                mean, mean_sq = (sums / count).chunk(2)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                update_running(self.running_mean, mean, self.momentum)
                update_running(self.running_var, var, self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def set_batch_norm_mesh(model: nn.Module, mesh) -> None:
    """Make every ``BatchNorm`` of ``model`` take its train-mode statistics
    over ``mesh``'s global batch (None, or a mesh of one process: the
    rank's own batch), and every ``PointMLP`` and ``FCStack`` know it runs
    under the mesh (its step then stays eager)."""
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    for module in model.modules():
        if isinstance(module, (BatchNorm, PointMLP, FCStack)):
            module.mesh = mesh


def takes_fused_bn_relu(bn: BatchNorm, x: torch.Tensor) -> bool:
    """Whether ``bn_relu`` runs the fused op: ``bn`` in train mode, on one
    process (no mesh), computing in float32, and ``x`` a float32 CUDA
    tensor."""
    return (bn.training and bn.mesh is None and bn.dtype == torch.float32
            and x.device.type == "cuda" and x.dtype == torch.float32)


def _global_hooks() -> bool:
    """Whether a global module hook is set (the hooks that ``nn.Module``'s
    call checks besides a module's own)."""
    from torch.nn.modules import module as nn_module

    return bool(nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks
                or nn_module._global_backward_hooks
                or nn_module._global_backward_pre_hooks)


def takes_body_graph(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``module`` (a ``PointMLP`` or an ``FCStack``) replays its
    step as CUDA graphs (``models/body_graph.py``) on ``x``: train mode,
    grad enabled, ``x`` a contiguous float32 CUDA tensor, no mesh, every
    layer at float32, every batch norm on the fused route, and no hook that
    would run on a layer (a replay runs none)."""
    if not (module.training and torch.is_grad_enabled() and x.device.type == "cuda"
            and x.dtype == torch.float32 and x.is_contiguous() and module.mesh is None
            and not _global_hooks()):
        return False
    return all(layer.dtype == torch.float32
               and not (layer._forward_hooks or layer._forward_pre_hooks
                        or layer._backward_hooks or layer._backward_pre_hooks)
               and (not isinstance(layer, BatchNorm) or takes_fused_bn_relu(layer, x))
               for layer in module.children())


def bn_relu(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``torch.relu(bn(x))``, through the fused train-mode op
    (``ops/bn_relu.py``, on a contiguous copy of a strided ``x``; an empty
    ``x`` raises there) where ``takes_fused_bn_relu`` holds."""
    if takes_fused_bn_relu(bn, x):
        return bn_relu_train(x.contiguous(), bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps, bn.momentum)
    return torch.relu(bn(x))


class PointMLP(nn.Module):
    """Per-point Dense -> BN -> ReLU stack (conv1d with filter size 1;
    reference: src/encoders_decoders.py:37-68)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 bn_momentum: float = 0.9, dtype=torch.float32):
        super().__init__()
        self.n_layers = len(features)
        for i, width in enumerate(features):
            self.add_module(f"conv_{i}", Dense(in_features, width, dtype))
            self.add_module(f"bn_{i}", BatchNorm(width, momentum=bn_momentum,
                                                 dtype=dtype))
            in_features = width
        self.mesh = None  # set by set_batch_norm_mesh
        self.graphs = BodyGraphs(counted=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if takes_body_graph(self, x):
            return self.graphs.call(self, self.layers, x, tuple(
                (bn.eps, bn.momentum) for bn in self.children() if isinstance(bn, BatchNorm)))
        return self.layers(x)

    def layers(self, x: torch.Tensor) -> torch.Tensor:
        """The eager forward."""
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            x = bn_relu(getattr(self, f"bn_{i}"), x)
        return x


class ConvUpsampleDecoder(nn.Module):
    """Per-point conv decoder with tile upsampling (reference:
    src/encoders_decoders.py:150-196): Dense -> [BN] -> ReLU per layer, the
    last layer linear with an optional finishing BN, and after layer i,
    where ``upsample_sizes[i]`` is set, the point axis tiled that many times
    (``jnp.tile``: the whole [n, c] block repeated, not each point)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 upsample_sizes: Sequence[int | None] | None = None,
                 use_bn: bool = True, bn_finish: bool = False,
                 bn_momentum: float = 0.9, dtype=torch.float32):
        super().__init__()
        self.n_layers = len(features)
        self.upsample_sizes = (None if upsample_sizes is None
                               else tuple(upsample_sizes))
        self.has_bn = []
        for i, width in enumerate(features):
            last = i == self.n_layers - 1
            self.add_module(f"conv_{i}", Dense(in_features, width, dtype))
            bn = (use_bn and not last) or (last and bn_finish)
            if bn:
                self.add_module(f"bn_{i}", BatchNorm(width, momentum=bn_momentum,
                                                     dtype=dtype))
            self.has_bn.append(bn)
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            if self.has_bn[i]:
                x = getattr(self, f"bn_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
            if self.upsample_sizes is not None and self.upsample_sizes[i]:
                reps = self.upsample_sizes[i]
                x = x.repeat((1,) * (x.dim() - 2) + (reps, 1))
        return x


class FCStack(nn.Module):
    """Fully-connected stack, ReLU between layers, the last layer linear
    (reference: src/encoders_decoders.py:86-147, without batch norm, which
    the victim's decoder does not use)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.n_layers = len(features)
        for i, width in enumerate(features):
            self.add_module(f"fc_{i}", Dense(in_features, width, dtype))
            in_features = width
        self.mesh = None  # set by set_batch_norm_mesh
        self.graphs = BodyGraphs()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if takes_body_graph(self, x):
            return self.graphs.call(self, self.layers, x)
        return self.layers(x)

    def layers(self, x: torch.Tensor) -> torch.Tensor:
        """The eager forward."""
        for i in range(self.n_layers):
            x = getattr(self, f"fc_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x
