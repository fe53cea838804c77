"""The ``.npy`` artifact store, the eval_stats writers and the report plots
(copies of ``geometric_adv_tpu.utils``' modules that need no JAX, pinned by
tests), and the device traces."""

from geometric_adv_tpu_torch.utils.artifacts import (
    artifact_name,
    load_data,
    save_artifact,
)

__all__ = ["artifact_name", "load_data", "save_artifact"]
