"""Operations of the PointNet victim (``configs/pointnet_ae_chamfer_2048.json``)
for one unit of work, whatever implements them.

Counted: 2 * in * out for each Dense row (the encoder's per point, the
decoder's per cloud) in the forward; in the attack, where the victim is
frozen, their input gradients as much again; in training, input and weight
gradients, twice the forward, less the first layer's input gradient, which
no implementation needs; 10 FP32 operations for each point pair of each
chamfer (the distance's 8 and a minimum in each direction, as
``core/peaks.py::kernel_bound`` counts them). Elementwise work (batch norm,
ReLU, Adam, the chamfer's backward) counts nothing.
"""


def dense_flops(widths) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def forward(cfg: dict) -> tuple[int, int, int]:
    """(encoder per cloud, decoder per cloud, the first layer per cloud)."""
    n = cfg["n_points"]
    enc = [3] + list(cfg["encoder_filters"])
    dec = [cfg["bneck_size"]] + list(cfg["decoder_sizes"]) + [3 * n]
    return n * dense_flops(enc), dense_flops(dec), n * 2 * 3 * enc[1]


def chamfer(n: int, m: int) -> int:
    return 10 * n * m


def per_unit(entry: str, cfg: dict, traffic: dict) -> float:
    """Operations of one pair-iteration of the attack, or of one training sample."""
    enc, dec, first = forward(cfg)
    n = cfg["n_points"]
    if entry == "attack":
        return 2 * (enc + dec) + 2 * chamfer(n, n)
    if entry == "train_ae":
        return 3 * (enc + dec) - first + chamfer(n, n)
    raise ValueError(f"no count for the entry {entry!r}")
