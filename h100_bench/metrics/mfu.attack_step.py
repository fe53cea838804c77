"""The attack step's share of the FP32 peak: the victim's GEMMs forward and
their input gradients, and both chamfers."""

from h100_bench.core.readers import mfu


def read(record):
    return mfu(record, "attack")
