"""Weight bridge: the JAX package's flax variables -> the port's state dict.

Takes the nested dicts of numpy arrays that ``geometric_adv_tpu`` keeps
(``params`` and ``batch_stats``, as its orbax checkpoints restore them) and
returns a ``state_dict`` for ``models.pointnet_ae.PointNetAE``:

- Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``, ``bias`` as is;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and the
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

It needs numpy only, so it imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict:
    sd = {}
    for part, layers in params.items():
        for layer, leaves in layers.items():
            key = f"{part}.{layer}"
            if "kernel" in leaves:
                sd[f"{key}.weight"] = np.asarray(leaves["kernel"]).T
                sd[f"{key}.bias"] = np.asarray(leaves["bias"])
            else:
                stats = batch_stats[part][layer]
                sd[f"{key}.weight"] = np.asarray(leaves["scale"])
                sd[f"{key}.bias"] = np.asarray(leaves["bias"])
                sd[f"{key}.running_mean"] = np.asarray(stats["mean"])
                sd[f"{key}.running_var"] = np.asarray(stats["var"])
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
