"""K3 (csrc/chamfer_grad.cu, grad1_kernel<false>) in the attack: its bound
at the call's shape over its mean time per launch."""

from h100_bench.core.readers import roofline_pct


def read(record):
    return roofline_pct(record, "attack", "grad1_kernel<false>", "chamfer_grad1_cuda")
