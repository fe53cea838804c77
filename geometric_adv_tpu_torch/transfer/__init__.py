"""Transfer autoencoders (AtlasNet, FoldingNet) that evaluate how an attack
transfers, and the metro (mesh Hausdorff) eval of AtlasNet
(reference: transfer/run_transfer.py)."""

from geometric_adv_tpu_torch.transfer.metro import (
    atlasnet_generate_mesh,
    metro_distance,
    metro_eval,
)
from geometric_adv_tpu_torch.transfer.trainers import (
    AtlasNetTrainer,
    FoldingNetTrainer,
    get_transfer_ae,
    load_transfer_arch,
    save_transfer_arch,
)

__all__ = [
    "AtlasNetTrainer",
    "FoldingNetTrainer",
    "get_transfer_ae",
    "load_transfer_arch",
    "save_transfer_arch",
    "atlasnet_generate_mesh",
    "metro_distance",
    "metro_eval",
]
