"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Skipped where ``torch.cuda.is_available()`` is false.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from geometric_adv_tpu_torch.ops import chamfer as ch
from geometric_adv_tpu_torch.ops.cuda import chamfer as cu

pytestmark = pytest.mark.cuda
GRAD_TOL = 2.6e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tie_clouds(b, n, m, seed):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(b, n, 3).astype(np.float32)
    x2 = rng.randn(b, m, 3).astype(np.float32)
    if m > 17:
        x2[:, 5] = x2[:, 17]  # duplicated point: first index wins
        x1[:, 0] = x2[:, 17]
    return torch.from_numpy(x1), torch.from_numpy(x2)


@pytest.mark.parametrize("b,n,m", [(3, 37, 300), (2, 256, 256), (4, 257, 1000),
                                   (1, 1, 5), (2, 600, 20)])
def test_kernels_match_plain_versions(cuda, b, n, m):
    a, c = (t.to(cuda) for t in tie_clouds(b, n, m, seed=n + m))
    got = cu.nn_distance_cuda(a, c)
    want = ch.nn_distance_plain(a, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(cu.nn_distance_values_cuda(a, c), (want[0], want[2])):
        assert torch.equal(g, w)
    if m > 17:
        assert (got[1][:, 0] == 5).all()
    gen = torch.Generator().manual_seed(b)
    g1 = torch.rand(b, n, generator=gen).to(cuda)
    g2 = torch.rand(b, m, generator=gen).to(cuda)
    k3 = cu.chamfer_grad1_cuda(a, c, got[1], got[3], g1, g2)
    p3 = ch.chamfer_grad1_plain(a, c, got[1], got[3], g1, g2)
    torch.cuda.synchronize()
    assert (k3 - p3).abs().max().item() <= GRAD_TOL


def test_autograd_on_card_goes_through_the_kernels(cuda):
    a, c = tie_clouds(2, 100, 90, seed=1)
    ta = a.to(cuda).requires_grad_(True)
    cu.reset_launch_counts()
    ch.chamfer_loss_per_pc(ta, c.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert cu.launch_counts() == {"nn_distance_cuda": 2,
                                  "nn_distance_values_cuda": 0,
                                  "chamfer_grad1_cuda": 1}
    ha = a.clone().requires_grad_(True)
    ch.chamfer_loss_per_pc(ha, c).sum().backward()
    assert (ta.grad.cpu() - ha.grad).abs().max().item() <= GRAD_TOL


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a, c = (t.to(cuda) for t in tie_clouds(2, 30, 40, seed=2))
    with pytest.raises(TypeError):
        cu.nn_distance_cuda(a.double(), c.double())
    with pytest.raises(ValueError):
        cu.nn_distance_cuda(a.transpose(0, 1), c[:1])
    with pytest.raises(ValueError):
        cu.nn_distance_values_cuda(a, c[:1])
    with pytest.raises(ValueError):
        cu.nn_distance_cuda(a[:, :0], c)
    _, i1, _, i2 = cu.nn_distance_cuda(a, c)
    g1 = torch.ones(2, 30, device=cuda)
    g2 = torch.ones(2, 40, device=cuda)
    with pytest.raises(TypeError):
        cu.chamfer_grad1_cuda(a, c, i1.long(), i2, g1, g2)
    with pytest.raises(ValueError):
        cu.chamfer_grad1_cuda(a, c, i1, i2, g1.t().contiguous().t(), g2)
