"""Kernels launched per training step of the victim (train/trainer.py),
from the trace."""

from h100_bench.core.readers import launches


def read(record):
    return launches(record, "train_ae")
