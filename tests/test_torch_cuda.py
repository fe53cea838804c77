"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Skipped where ``torch.cuda.is_available()`` is false.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from geometric_adv_tpu_torch.ops import chamfer as ch
from geometric_adv_tpu_torch.ops import emd
from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
from geometric_adv_tpu_torch.ops.cuda import emd as cu_emd

pytestmark = pytest.mark.cuda
GRAD_TOL = 2.6e-6
# EMD sweep bars on the card (geometric_adv_tpu/cli/verify_tpu.py:482):
# cost rtol 1e-5, gradients atol 1e-4 * max|g|
EMD_COST_RTOL = 1e-5
EMD_GRAD_REL = 1e-4


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


def emd_clouds(b, n, m, seed):
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32) - 0.5
    x2 = rng.rand(b, m, 3).astype(np.float32) - 0.5
    return torch.from_numpy(x1), torch.from_numpy(x2)


def assert_sweep_close(got, want):
    cost, g1, g2 = got
    c_ref, g1_ref, g2_ref = want
    assert torch.allclose(cost, c_ref, rtol=EMD_COST_RTOL, atol=0)
    scale = g1_ref.abs().max().item()
    for g, r in ((g1, g1_ref), (g2, g2_ref)):
        if g is not None:
            assert (g - r).abs().max().item() <= EMD_GRAD_REL * scale


@pytest.mark.parametrize("kernel", ["block", "tiled"])
@pytest.mark.parametrize("b,n,m", [(3, 37, 300), (2, 256, 256), (4, 1000, 513),
                                   (2, 130, 1024), (1, 1, 5), (2, 600, 20)])
def test_emd_kernels_match_plain_version(cuda, kernel, b, n, m):
    fn = {"block": cu_emd.emd_sweep_block_cuda,
          "tiled": cu_emd.emd_sweep_tiled_cuda}[kernel]
    a, c = (t.to(cuda) for t in emd_clouds(b, n, m, seed=n + m))
    want = emd.emd_sweep_plain(a, c, True, True)
    full = fn(a, c, emd._LEVELS, True, True)
    torch.cuda.synchronize()
    assert_sweep_close(full, want)
    for flags in ((False, False), (True, False), (False, True)):
        part = fn(a, c, emd._LEVELS, *flags)
        assert (part[1] is None) != flags[0] and (part[2] is None) != flags[1]
        assert torch.equal(part[0], full[0])  # the cost is mode-independent
        assert_sweep_close(part, want)


def test_emd_autograd_on_card_goes_through_the_kernels(cuda):
    a, c = emd_clouds(2, 100, 90, seed=3)
    ta = a.to(cuda).requires_grad_(True)
    cu_emd.reset_launch_counts()
    emd.emd_loss_fused(ta, c.to(cuda)).sum().backward()
    big = emd_clouds(1, 1100, 64, seed=4)
    emd.emd_loss_fused(*(t.to(cuda) for t in big))
    torch.cuda.synchronize()
    assert cu_emd.launch_counts() == {"emd_sweep_block_cuda": 1,
                                      "emd_sweep_tiled_cuda": 1}
    ha = a.clone().requires_grad_(True)
    emd.emd_loss_fused(ha, c).sum().backward()
    scale = ha.grad.abs().max().item()
    assert (ta.grad.cpu() - ha.grad).abs().max().item() <= EMD_GRAD_REL * scale


def test_emd_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a, c = (t.to(cuda) for t in emd_clouds(2, 30, 40, seed=2))
    with pytest.raises(TypeError):
        cu_emd.emd_sweep_tiled_cuda(a.double(), c.double(), emd._LEVELS, True, True)
    with pytest.raises(ValueError):
        cu_emd.emd_sweep_block_cuda(a.transpose(0, 1), c, emd._LEVELS, True, True)
    big = torch.zeros(1, 1025, 3, device=cuda)
    with pytest.raises(ValueError):
        cu_emd.emd_sweep_block_cuda(big, big, emd._LEVELS, True, True)
