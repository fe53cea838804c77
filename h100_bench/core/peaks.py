"""The yardstick's constants: the published peaks of one NVIDIA H100 SXM and
the least time each hand-written kernel of the port could take.

A frozen copy of ``chip_smoke.py``'s ``FP32_PEAK, FP64_PEAK, HBM_RATE`` and
``kernel_bound`` (operations and bytes counted from the call's shapes), kept
here so that a change to the program cannot move the bounds it is measured
against. Peaks are NVIDIA's H100 datasheet rates (SXM part, dense, 700 W).
"""

FP32_PEAK, FP64_PEAK, HBM_RATE = 67e12, 34e12, 3.35e12


def kernel_bound(name, b, n, m, pairs=None, zero_share=None):
    """(bound_ms, bound_by, the operations' type) of one call at [b, n, 3] x
    [b, m, 3]: the larger of the operations over the card's peak for their
    type and the bytes over its memory rate, each input read once and each
    output written once. Operations per distance pair: 8 FP32 for the
    distance (3 sub, 3 mul, 2 add) and a minimum per direction (K1, K2, K5;
    for K8, one minimum on the ``pairs`` of both directions that each
    query's own lower bounds leave, the least any exact search over its
    spheres scans; K8 reads the prepared clouds, 16 bytes a point, and its
    preparation, bound by its bytes, reads 12 and writes 16); per pair and level
    of the EMD sweep (g1 mode), 27 FP32 (the distance, the kernel value, the
    row, column and cost products and sums, the g1 terms) and 6 FP64 (its
    three float64 sums, product and add), but only the distance (8 FP32) for
    the ``zero_share`` of a level's pairs whose kernel value is exactly +0
    (K6 and K7 skip their terms); K3/K4 are O(n + m)."""
    levels = 10
    cloud = b * (n + m) * 12
    fp32 = fp64 = 0.0
    if name in ("nn_distance_cuda", "nn_distance_values_cuda", "chamfer_loss_payloads_cuda"):
        fp32 = 10.0 * b * n * m
        out = {"nn_distance_cuda": 8 * (n + m), "nn_distance_values_cuda": 4 * (n + m),
               "chamfer_loss_payloads_cuda": 8 * (n + m) + 28 * n}[name]
        nbytes = cloud + b * out
    elif name in ("chamfer_grad1_cuda", "chamfer_grad1_vpu_cuda"):
        fp32 = 20.0 * b * (n + m)
        nbytes = cloud + b * (8 * (n + m) + 12 * n)  # idx, g in; grad out
    elif name == "nn_direction_hier_cuda":  # both directions, prepared clouds
        fp32 = 9.0 * pairs
        nbytes = b * (n + m) * (16 + 8) + b * 16 * (-(-n // 128) + -(-m // 128))
    elif name == "hier_prep_cuda":  # both clouds; the sort's compares are few
        nbytes = b * (n + m) * (12 + 16) + b * 16 * (-(-n // 128) + -(-m // 128))
    else:  # the EMD sweeps, g1 only
        live = levels - sum(zero_share or ())
        fp32 = (8.0 * levels + 19.0 * live) * b * n * m
        fp64 = 6.0 * live * b * n * m
        nbytes = cloud + b * (4 + 12 * n)
    times = {"FP32": fp32 / FP32_PEAK, "FP64": fp64 / FP64_PEAK, "bytes": nbytes / HBM_RATE}
    kind = max(times, key=times.get)
    return times[kind] * 1e3, "bytes" if kind == "bytes" else "operations", kind
