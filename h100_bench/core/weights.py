"""Seeded random weights, made on the device in one draw and handed to both
the program and the reference.

The layout (names and shapes) is the model's; the values are the
benchmark's: a Dense weight [out, in] is normal with variance 1/in, a Dense
bias normal with standard deviation 0.05, a batch norm's scale 1 + 0.1 N and
shift 0.1 N, its statistics 0 and 1 unless the entry sets them.
"""

from __future__ import annotations

import torch


def _kind(name: str, shapes: dict) -> str:
    stem, leaf = name.rsplit(".", 1)
    if leaf in ("running_mean", "running_var"):
        return leaf
    if f"{stem}.running_mean" in shapes:
        return "bn_" + leaf
    return "dense_" + leaf


def seeded_weights(shapes: dict, gen: torch.Generator, device) -> dict:
    """{name: float32 tensor on ``device``} for the layout ``shapes``
    ({name: shape}), drawn from ``gen`` in one call."""
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), chunk in zip(shapes.items(), draw.split(sizes)):
        x = chunk.reshape(shape)
        kind = _kind(name, shapes)
        if kind == "dense_weight":
            x = x * shape[1] ** -0.5
        elif kind == "dense_bias":
            x = x * 0.05
        elif kind == "bn_weight":
            x = 1 + 0.1 * x
        elif kind == "bn_bias":
            x = 0.1 * x
        elif kind == "running_mean":
            x = torch.zeros_like(x)
        elif kind == "running_var":
            x = torch.ones_like(x)
        else:
            raise ValueError(f"no rule for the weight {name!r}")
        out[name] = x.contiguous()
    return out


def layout(module) -> dict:
    """{name: shape} of a module's parameters and buffers."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
