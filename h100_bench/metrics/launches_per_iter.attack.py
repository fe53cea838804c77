"""Kernels launched per attack iteration (attack/core.py::attack_batch),
from the trace."""

from h100_bench.core.readers import launches


def read(record):
    return launches(record, "attack")
