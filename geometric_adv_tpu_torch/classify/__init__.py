"""Semantic evaluation: PointNet classifier training and inference."""

from geometric_adv_tpu_torch.classify.trainer import ClassifierTrainer

__all__ = ["ClassifierTrainer"]
