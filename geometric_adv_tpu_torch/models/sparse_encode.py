"""Sparse (argmax-gathered) input gradient of the frozen PointNet encoder
(``geometric_adv_tpu/models/sparse_encode.py``).

The attack differentiates the victim with respect to its input only, with
BN on its frozen running statistics. The encoder is a per-point MLP
followed by a max over points (reference: src/encoders_decoders.py:37-68),
so ``dz/dx`` is nonzero only at the <= bneck rows that hold each channel's
maximum. Dense autograd still runs every layer's backward over all n point
rows; this ``torch.autograd.Function`` runs it over the bneck argmax rows:

- forward: the model's own encoder, unchanged, so ``z`` is bit-equal to
  ``PointNetAE.encode``, plus ``argmax`` over the pre-pool map (the first
  maximal row, as ``jnp.argmax``). Saved for the backward: ``(x, idx)``.
- backward: gathers the argmax rows ``x[idx]`` and re-runs the encoder's
  layers on them alone for the ReLU masks, seeds the diagonal cotangent
  (row r carries channel r's gradient), then runs the chain
  ``G * mask -> G * gamma * rsqrt(var + eps) -> G @ W^T`` on [..., bneck, c]
  in float32, and returns the [..., bneck, 3] result to the point rows with
  ``SCATTER_IMPL``: "onehot" (a [bneck, n] 0/1 matrix in a batched product,
  the default; duplicate rows add in a fixed order) or "scatter"
  (``index_add_``, whose order on the card is the atomics': not
  deterministic).

Exactness: equal to dense autograd up to float32 summation order, except on
exact max ties, where dense autograd (``amax``) splits the cotangent evenly
and this path follows the first argmax row; a dead channel (every row 0)
gets zero gradient on both paths because its mask is 0 (PARITY.md). The
recomputed masks equal the full forward's only where the gathered rows
round as they did beside the other rows: a BLAS may pick another algorithm
for [b * bneck, c] than for [b * n, c], so a ReLU input within rounding of 0
can flip; ``mask_flips`` counts them.

Routing: ``AttackRunner(encoder_vjp=...)``, whose "auto" is dense on the
CPU (the golden artifacts pin the dense bits) and on the card, where the
sparse path measured faster at 250 pairs a call but slower at the 24 the
CLI sends at 2048 points (PERF.md §6).
"""

from __future__ import annotations

import torch

SCATTER_IMPL = "onehot"
BACKWARD_CALLS = 0  # backward passes run by the sparse Function

_BN_EPS = 1e-5


def encoder_layer_tables(encoder):
    """Per layer (float32 weight [c_out, c_in], the channelwise backward
    scale ``gamma * rsqrt(running_var + eps)`` or None where the layer has no
    BN) of a ``PointMLP``-style encoder (``conv_{i}``/``bn_{i}``)."""
    weights, scales = [], []
    for i in range(encoder.n_layers):
        weights.append(getattr(encoder, f"conv_{i}").weight.detach().float())
        bn = getattr(encoder, f"bn_{i}", None)
        scales.append(None if bn is None else (
            bn.weight.detach().float()
            * torch.rsqrt(bn.running_var.detach().float() + _BN_EPS)))
    return weights, scales


@torch.no_grad()
def relu_masks(encoder, x: torch.Tensor) -> list[torch.Tensor]:
    """The ReLU masks (input > 0) of every encoder layer on the rows of
    ``x``: the BN output where the layer has one, else the Dense output."""
    masks = []
    h = x
    for i in range(encoder.n_layers):
        h = getattr(encoder, f"conv_{i}")(h)
        bn = getattr(encoder, f"bn_{i}", None)
        if bn is not None:
            h = bn(h)
        masks.append(h > 0)
        h = torch.relu(h)
    return masks


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(x, idx[..., :, None], dim=-2)


@torch.no_grad()
def mask_flips(model, x: torch.Tensor) -> int:
    """How many (row, layer, channel) mask bits of the argmax rows, re-run
    alone as the backward does, differ from the same rows' bits in the full
    forward over all points."""
    encoder = model.encoder
    idx = encoder(x).argmax(dim=-2)
    full = relu_masks(encoder, x)
    alone = relu_masks(encoder, _gather_rows(x, idx))
    return int(sum((_gather_rows(f, idx) != a).sum() for f, a in zip(full, alone)))


class _SparseEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model, tables):
        if model.training:
            raise ValueError("the sparse encoder VJP needs the model in eval "
                             "mode (frozen BN statistics)")
        pre = model.encoder(x)
        z = pre.amax(dim=-2)
        idx = pre.argmax(dim=-2)  # the first maximal row per channel
        ctx.save_for_backward(x, idx)
        ctx.model, ctx.tables = model, tables
        return z

    @staticmethod
    def backward(ctx, dz):
        global BACKWARD_CALLS
        BACKWARD_CALLS += 1
        x, idx = ctx.saved_tensors
        weights, scales = ctx.tables
        masks = relu_masks(ctx.model.encoder, _gather_rows(x, idx))
        n, bneck = x.shape[-2], dz.shape[-1]
        eye = torch.eye(bneck, dtype=torch.float32, device=dz.device)
        g = dz.float()[..., None, :] * eye  # row r carries channel r
        for layer in range(len(weights) - 1, -1, -1):
            g = torch.where(masks[layer], g, 0.0)
            if scales[layer] is not None:
                g = g * scales[layer]
            g = torch.matmul(g, weights[layer])
        # g: [..., bneck, 3], the input gradient of each gathered row
        if SCATTER_IMPL == "onehot":
            onehot = (idx[..., :, None] == torch.arange(n, device=idx.device)
                      ).to(torch.float32)
            dx = torch.matmul(onehot.transpose(-1, -2), g)
        elif SCATTER_IMPL == "scatter":
            lead = idx.shape[:-1]
            b = lead.numel()
            rows = (idx.reshape(b, bneck)
                    + n * torch.arange(b, device=idx.device)[:, None])
            dx = torch.zeros(b * n, g.shape[-1], dtype=torch.float32,
                             device=g.device)
            dx.index_add_(0, rows.reshape(-1), g.reshape(b * bneck, -1))
            dx = dx.reshape(lead + (n, g.shape[-1]))
        else:
            raise ValueError(f"unknown SCATTER_IMPL {SCATTER_IMPL!r}")
        return dx.to(x.dtype), None, None


def make_sparse_encode(model):
    """``encode(x) -> z`` of a ``PointNetAE``-style model (an ``encoder``
    of ``conv_{i}``/``bn_{i}`` layers, max over points) with the
    argmax-sparse backward; ``z`` is bit-equal to ``model.encode(x)``. The
    backward's weights and BN scales are taken here, once, as the JAX
    package's ``make_sparse_encode`` takes them: the model stays frozen."""
    tables = encoder_layer_tables(model.encoder)

    def encode(x: torch.Tensor) -> torch.Tensor:
        return _SparseEncode.apply(x, model, tables)

    return encode
