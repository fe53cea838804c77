"""The fused train-mode batch norm + ReLU op (ops/bn_relu.py) on the CPU:
its plain closed-form version against the composed ``torch.relu(bn(x))``
of models/layers.py, and the routing that picks between them.

Bars: the forward and the running statistics bit for bit (both take the
batch moments as BatchNorm does, then the same operations); in float64,
the closed-form gradients against autograd through the composed formula
at 1e-10 of each gradient's largest entry, and
``torch.autograd.gradcheck``'s defaults. Both take the same statistics, so
the clip's branch agrees too.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from geometric_adv_tpu_torch.models.layers import BatchNorm, PointMLP, takes_fused_bn_relu
from geometric_adv_tpu_torch.ops import bn_relu as op
from geometric_adv_tpu_torch.ops.cuda import bn_relu as cu

SHAPES = [(2, 37, 64), (3, 50, 7), (4, 16, 128), (1, 9, 1)]
MOMENTUM = 0.9


def make_bn(c, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, momentum=MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=gen) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn.to(dtype).train()


def make_x(shape, dtype=torch.float32, seed=1):
    rng = np.random.RandomState(seed)
    # channel offsets and scales as a Dense layer's outputs have them
    c = shape[-1]
    x = rng.randn(*shape) * rng.uniform(0.2, 3.0, c) + rng.uniform(-2, 2, c)
    return torch.from_numpy(x).to(dtype)


def fused(bn, x):
    return op.bn_relu_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                            bn.eps, bn.momentum)


def rel_err(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_the_composed_version(shape):
    x = make_x(shape)
    composed, plain = make_bn(shape[-1]), make_bn(shape[-1])
    want = torch.relu(composed(x))
    got = fused(plain, x)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(plain.running_mean, composed.running_mean)
    assert torch.equal(plain.running_var, composed.running_var)


@pytest.mark.parametrize("shape", [(2, 37, 64), (3, 50, 7), (1, 9, 1)])
def test_plain_backward_passes_gradcheck(shape):
    bn = make_bn(shape[-1], torch.float64)
    x = make_x(shape, torch.float64, seed=2).requires_grad_(True)
    weight = bn.weight.detach().clone().requires_grad_(True)
    bias = bn.bias.detach().clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w, b: op.bn_relu_train(x, w, b, bn.running_mean, bn.running_var,
                                         bn.eps, bn.momentum),
        (x, weight, bias))


def constant_below_zero(n):
    """A value whose constant channel of n rows gives mean(x*x) - mean(x)^2
    < 0 in float64 (the clip's branch)."""
    for v in np.linspace(0.1, 3.0, 300):
        col = torch.full((n, 1), float(v), dtype=torch.float64)
        m = col.mean(dim=0)
        if float((col * col).mean(dim=0) - m * m) < 0:
            return float(v)
    raise AssertionError("no constant below zero in the scan")


@pytest.mark.parametrize("case", ["plain", "constant_zero", "constant_below", "dead"])
def test_closed_form_gradients_match_autograd_of_the_composed_formula(case):
    """dx, dweight and dbias against autograd through BatchNorm then ReLU
    in float64, where both take the same statistics: the clip's
    two branches (a constant channel of 0 gives exactly 0 and flows, one
    below zero does not), a channel the ReLU kills, and the running
    statistics."""
    rows, c = 300, 6
    x = make_x((rows, c), torch.float64, seed=3)
    if case == "constant_zero":
        x[:, 1] = 0.0
    elif case == "constant_below":
        x[:, 1] = constant_below_zero(rows)
    composed, plain = make_bn(c, torch.float64), make_bn(c, torch.float64)
    if case == "dead":
        with torch.no_grad():
            plain.bias[2] = composed.bias[2] = -50.0
    dy = make_x((rows, c), torch.float64, seed=4)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    torch.relu(composed(xs[0])).backward(dy)
    fused(plain, xs[1]).backward(dy)
    for got, want in ((xs[1].grad, xs[0].grad), (plain.weight.grad, composed.weight.grad),
                      (plain.bias.grad, composed.bias.grad)):
        assert rel_err(got, want) < 1e-10
    assert torch.equal(plain.running_mean, composed.running_mean)
    assert torch.equal(plain.running_var, composed.running_var)
    _, stats = op.bn_relu_forward_plain(x, *op.batch_moments(x), plain.weight, plain.bias,
                                        plain.eps)
    flag = stats[cu.STATS.index("flag")]
    if case == "constant_below":
        assert flag[1] == 0 and stats[1, 1] == 0  # clipped: no gradient through v
    elif case == "constant_zero":
        assert flag[1] == 1 and stats[1, 1] == 0  # exactly 0: flows
    if case == "dead":
        assert plain.bias.grad[2] == 0 and plain.weight.grad[2] == 0


def cuda_like(**kw):
    """Stands in for an input tensor in the routing predicate (this host
    has no CUDA device); a contiguous float32 CUDA input unless changed.
    The predicate must not ask for contiguity or size: a strided input
    takes the op on a contiguous copy, an empty one raises in the wrapper."""
    base = dict(device=torch.device("cuda", 0), dtype=torch.float32, contiguous=True, numel=8)
    base.update(kw)
    return SimpleNamespace(device=base["device"], dtype=base["dtype"],
                           is_contiguous=lambda: base["contiguous"],
                           numel=lambda: base["numel"])


@pytest.mark.parametrize("case,want", [
    ("cuda_train", True),
    ("cpu", False),
    ("eval", False),
    ("mesh", False),
    ("bf16_layer", False),
    ("bf16_input", False),
    ("not_contiguous", True),
    ("empty", True),
])
def test_routing_picks_the_fused_op_only_where_it_applies(case, want):
    bn = BatchNorm(4, dtype="bfloat16" if case == "bf16_layer" else "float32")
    bn.train(case != "eval")
    if case == "mesh":
        bn.mesh = SimpleNamespace(size=2)
    x = cuda_like(**{"cpu": dict(device=torch.device("cpu")),
                     "bf16_input": dict(dtype=torch.bfloat16),
                     "not_contiguous": dict(contiguous=False),
                     "empty": dict(numel=0)}.get(case, {}))
    assert takes_fused_bn_relu(bn, x) is want


@pytest.mark.parametrize("train", [True, False])
def test_point_mlp_on_the_cpu_keeps_the_composed_path_bit_for_bit(train):
    torch.manual_seed(0)
    mlp = PointMLP(3, [16, 32, 8]).train(train)
    x = torch.randn(2, 40, 3)
    ref = PointMLP(3, [16, 32, 8]).train(train)
    ref.load_state_dict(mlp.state_dict())
    got = mlp(x)
    want = x
    for i in range(ref.n_layers):
        want = torch.relu(getattr(ref, f"bn_{i}")(getattr(ref, f"conv_{i}")(want)))
    assert torch.equal(got, want)
    for name, buf in mlp.named_buffers():
        assert torch.equal(buf, dict(ref.named_buffers())[name])


def test_fused_route_takes_a_strided_input_on_a_contiguous_copy(monkeypatch):
    """``bn_relu`` on the fused route (forced here, where the op runs its
    plain version) with a transposed, non-contiguous input: the output and
    the running statistics equal the composed version's on the same values
    laid out contiguously bit for bit (ATen's means round by layout), and
    its own on the strided input to float32 rounding."""
    from geometric_adv_tpu_torch.models import layers

    x = make_x((3, 40, 16)).transpose(0, 1)
    assert not x.is_contiguous()
    fused, composed, strided = make_bn(16), make_bn(16), make_bn(16)
    monkeypatch.setattr(layers, "takes_fused_bn_relu", lambda bn, x: True)
    got = layers.bn_relu(fused, x)
    assert got.shape == x.shape
    assert rel_err(got, torch.relu(strided(x))) <= 1e-5
    assert torch.equal(got, torch.relu(composed(x.contiguous())))
    assert torch.equal(fused.running_mean, composed.running_mean)
    assert torch.equal(fused.running_var, composed.running_var)


@pytest.mark.parametrize("shape", [(0, 8), (4, 0)])
def test_cuda_wrappers_reject_empty_inputs(shape):
    x = torch.zeros(shape)
    c = torch.zeros(shape[1])
    with pytest.raises(ValueError, match="non-empty"):
        cu.bn_relu_forward_cuda(x, c, c, c, c, c, c, 1e-5, MOMENTUM)
    with pytest.raises(ValueError, match="non-empty"):
        cu.bn_relu_backward_cuda(x, x, c, c, torch.zeros(len(cu.STATS), shape[1]))


def test_cuda_wrappers_reject_cpu_tensors():
    x = torch.zeros(4, 8)
    c = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cu.bn_relu_forward_cuda(x, c, c, c, c, c, c, 1e-5, MOMENTUM)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cu.bn_relu_backward_cuda(x, x, c, c, torch.zeros(len(cu.STATS), 8))
