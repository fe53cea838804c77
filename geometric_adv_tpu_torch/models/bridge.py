"""Weight and optimizer bridge: the JAX package's flax/optax state -> the
port's.

``state_dict_from_flax`` takes the nested dicts of numpy arrays that
``geometric_adv_tpu`` keeps (``params`` and ``batch_stats``, as its orbax
checkpoints restore them) and returns a ``state_dict`` for the port's model
of the same tree, whose sub-modules carry the flax names:

- a node with a ``kernel`` is a Dense: ``kernel [in, out]`` ->
  ``Linear.weight [out, in]``, ``bias`` as is;
- a node with a ``scale`` is a BatchNorm: ``scale``/``bias`` ->
  ``weight``/``bias``, and its ``batch_stats`` ``mean``/``var`` ->
  ``running_mean``/``running_var``.

The trees may have any depth (``PointNetAE``'s ``params[part][layer]``, the
classifier's ``params["conv1"]`` and ``params["transform_net1"]["tconv1"]``);
the port's parameter name is the path of keys joined with ``.``.

``adam_state_from_optax`` maps optax's ``ScaleByAdamState`` (``count`` and the
moment trees ``mu``, ``nu``, laid out like ``params``) the same way, into the
per-parameter state of ``torch.optim.Adam``, so that a run resumed from a JAX
checkpoint takes the same next step.

It needs numpy only, so it imports no jax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _nodes(tree: Mapping, prefix: str = ""):
    """(dotted path, node) of every node of ``tree`` that holds arrays (a
    layer's leaves), in the tree's order."""
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if any(not isinstance(v, Mapping) for v in sub.values()):
            yield path, sub
        else:
            yield from _nodes(sub, path + ".")


def _param_leaves(params: dict):
    """(port parameter name, numpy array in the port's layout) per leaf."""
    for key, leaves in _nodes(params):
        if "kernel" in leaves:
            yield f"{key}.weight", np.asarray(leaves["kernel"]).T
        else:
            yield f"{key}.weight", np.asarray(leaves["scale"])
        yield f"{key}.bias", np.asarray(leaves["bias"])


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict:
    sd = dict(_param_leaves(params))
    for key, stats in _nodes(batch_stats):
        sd[f"{key}.running_mean"] = np.asarray(stats["mean"])
        sd[f"{key}.running_var"] = np.asarray(stats["var"])
    return {k: _tensor(v) for k, v in sd.items()}


def adam_state_from_optax(count, mu: dict, nu: dict) -> dict:
    """{parameter name: {"step", "exp_avg", "exp_avg_sq"}} for
    ``torch.optim.Adam`` from optax's ``ScaleByAdamState`` fields."""
    step = torch.tensor(float(np.asarray(count)))
    nus = dict(_param_leaves(nu))
    return {
        name: {"step": step.clone(), "exp_avg": _tensor(m),
               "exp_avg_sq": _tensor(nus[name])}
        for name, m in _param_leaves(mu)
    }
