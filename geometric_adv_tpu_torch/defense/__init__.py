"""Defenses against geometric adversarial attacks: critical-points removal
and off-surface (kNN distance) outlier removal."""

from geometric_adv_tpu_torch.defense.critical import (
    get_critical_pc_non_critical_pc,
    get_critical_points,
)
from geometric_adv_tpu_torch.defense.surface import (
    get_outlier_pc_inlier_pc,
    knn_dists_per_point,
)

__all__ = [
    "get_critical_points",
    "get_critical_pc_non_critical_pc",
    "knn_dists_per_point",
    "get_outlier_pc_inlier_pc",
]
