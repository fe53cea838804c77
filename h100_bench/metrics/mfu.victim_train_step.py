"""The victim's training step's share of the FP32 peak: the GEMMs forward,
input and weight gradients, and the chamfer."""

from h100_bench.core.readers import mfu


def read(record):
    return mfu(record, "train_ae")
