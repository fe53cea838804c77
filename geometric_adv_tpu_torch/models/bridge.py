"""Weight and optimizer bridge: the JAX package's flax/optax state -> the
port's.

``state_dict_from_flax`` takes the nested dicts of numpy arrays that
``geometric_adv_tpu`` keeps (``params`` and ``batch_stats``, as its orbax
checkpoints restore them) and returns a ``state_dict`` for
``models.pointnet_ae.PointNetAE``:

- Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``, ``bias`` as is;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and the
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

``adam_state_from_optax`` maps optax's ``ScaleByAdamState`` (``count`` and the
moment trees ``mu``, ``nu``, laid out like ``params``) the same way, into the
per-parameter state of ``torch.optim.Adam``, so that a run resumed from a JAX
checkpoint takes the same next step.

It needs numpy only, so it imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch


def _param_leaves(params: dict):
    """(port parameter name, numpy array in the port's layout) per leaf."""
    for part, layers in params.items():
        for layer, leaves in layers.items():
            key = f"{part}.{layer}"
            if "kernel" in leaves:
                yield f"{key}.weight", np.asarray(leaves["kernel"]).T
                yield f"{key}.bias", np.asarray(leaves["bias"])
            else:
                yield f"{key}.weight", np.asarray(leaves["scale"])
                yield f"{key}.bias", np.asarray(leaves["bias"])


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict:
    sd = dict(_param_leaves(params))
    for part, layers in batch_stats.items():
        for layer, stats in layers.items():
            sd[f"{part}.{layer}.running_mean"] = np.asarray(stats["mean"])
            sd[f"{part}.{layer}.running_var"] = np.asarray(stats["var"])
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
