"""K1 (csrc/nn_distance.cu, nn_kernel<true>) in the attack: its bound at
the call's shape over its mean time per launch."""

from h100_bench.core.readers import roofline_pct


def read(record):
    return roofline_pct(record, "attack", "nn_kernel<true>", "nn_distance_cuda")
