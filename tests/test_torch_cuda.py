"""The hand-written CUDA kernels (K1-K8) against their plain PyTorch
versions, on the card. Skipped where ``torch.cuda.is_available()`` is false.

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
    args = (a, c, got[1], got[3], g1, g2)
    k3 = cu.chamfer_grad1_cuda(*args)
    # the plain version on the host: its scatter sums run in ascending j, as
    # K3's do (on the card they take atomics' order, up to 2 ulp away)
    host = ch.chamfer_grad1_plain(*(t.cpu() for t in args))
    assert torch.equal(k3.cpu(), host)


def test_autograd_on_card_goes_through_the_kernels(cuda):
    a, c = tie_clouds(2, 100, 90, seed=1)
    ta = a.to(cuda).requires_grad_(True)
    cu.reset_launch_counts()
    # the composed route (at n <= 1024 "auto" takes the fused loss, K5)
    ch.chamfer_loss_per_pc(ta, c.to(cuda), method="composed").sum().backward()
    torch.cuda.synchronize()
    assert cu.launch_counts() == {"nn_distance_cuda": 1,  # both directions
                                  "nn_distance_values_cuda": 0,
                                  "chamfer_grad1_cuda": 1,
                                  "chamfer_grad1_vpu_cuda": 0,
                                  "chamfer_loss_payloads_cuda": 0,
                                  "hier_prep_cuda": 0,
                                  "nn_direction_hier_cuda": 0}
    ha = a.clone().requires_grad_(True)
    ch.chamfer_loss_per_pc(ha, c, method="composed").sum().backward()
    assert (ta.grad.cpu() - ha.grad).abs().max().item() <= GRAD_TOL


def straddling_ties(b, n, m, seed):
    """tests/test_torch_ops_chamfer_ties.py's clouds (this file imports no
    JAX): exact ties across the kernels' tile, block, step and chunk
    boundaries, in both directions."""
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x1[:, 3] = x1[:, 1500] = x2[:, 7]
    x2[:, 1800] = x2[:, 5]
    x1[:, 40] = x2[:, 5]
    x1[:, 255] = x1[:, 256] = x2[:, 300]
    x2[:, 256] = x2[:, 255]
    x1[:, 600] = x2[:, 255]
    if n > 2100:
        x1[:, 2100] = x2[:, 7]
    return torch.from_numpy(x1), torch.from_numpy(x2)


@pytest.mark.parametrize("b,n,m", [(4, 2048, 2048), (2, 2500, 2048), (24, 2048, 2048)])
def test_forward_kernels_bit_equal_on_straddling_ties(cuda, b, n, m):
    """K1 and K2 bit-equal to their plain versions, first index on every
    tie; K5's d/i bit-equal to K1's, nn1 = x2[i1], cnt1 equal and snn1
    bit-equal to the plain version on the host (ascending j, as K5 sums);
    a second run bit-equal to the first."""
    a, c = straddling_ties(b, n, m, seed=n + b)
    x1, x2 = a.to(cuda), c.to(cuda)
    k1 = cu.nn_distance_cuda(x1, x2)
    want = ch.nn_distance_plain(x1, x2)
    for g, w in zip(k1, want):
        assert torch.equal(g, w)
    assert (k1[3][:, 7] == 3).all() and (k1[1][:, 40] == 5).all()
    assert (k1[3][:, 300] == 255).all() and (k1[1][:, 600] == 255).all()
    k2 = cu.nn_distance_values_cuda(x1, x2)
    assert torch.equal(k2[0], want[0]) and torch.equal(k2[1], want[2])
    k5 = cu.chamfer_loss_payloads_cuda(x1, x2)
    host = ch.chamfer_loss_payloads_plain(a, c)
    for k in range(4):
        assert torch.equal(k5[k], k1[k])
    assert torch.equal(k5[4], ch._take_points(x2, k1[1]))
    assert torch.equal(k5[5].cpu(), host[5]) and torch.equal(k5[6].cpu(), host[6])
    for first, again in ((k1, cu.nn_distance_cuda(x1, x2)),
                         (k2, cu.nn_distance_values_cuda(x1, x2)),
                         (k5, cu.chamfer_loss_payloads_cuda(x1, x2))):
        assert all(torch.equal(f, g) for f, g in zip(first, again))


@pytest.mark.parametrize("b,n,m", [(2, 37, 2048), (3, 300, 2500)])
def test_k5_payloads_on_long_segments(cuda, b, n, m):
    """x2 clustered on three x1 points: segments of hundreds of j, across
    K5's rounds, warps and staging passes. Every output bit-equal to the
    plain version on the host (snn1 summed in ascending j), twice."""
    rng = np.random.RandomState(b * n + m)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = (x1[:, rng.randint(0, 3, m)] + 1e-3 * rng.rand(b, m, 3)).astype(np.float32)
    a, c = torch.from_numpy(x1), torch.from_numpy(x2)
    host = ch.chamfer_loss_payloads_plain(a, c)
    assert host[6].max().item() >= 100
    for _ in range(2):
        got = cu.chamfer_loss_payloads_cuda(a.to(cuda), c.to(cuda))
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, host))


GRAD1_CASES = [("ties", 24, 2048, 2048), ("ties", 2, 2500, 2048),
               ("clustered", 2, 300, 2500), ("clustered", 3, 2048, 600)]


def grad1_inputs(kind, b, n, m):
    """Tie clouds, or x2 clustered on three x1 points (segments of hundreds
    of j, most segments empty), with uniform weights and the plain argmins,
    on the host."""
    rng = np.random.RandomState(b * n + m)
    if kind == "ties":
        a, c = straddling_ties(b, n, m, seed=n + m)
    else:
        x1 = rng.rand(b, n, 3).astype(np.float32)
        x2 = (x1[:, rng.randint(0, 3, m)] + 1e-3 * rng.rand(b, m, 3)).astype(np.float32)
        a, c = torch.from_numpy(x1), torch.from_numpy(x2)
    g1 = torch.from_numpy(rng.rand(b, n).astype(np.float32))
    g2 = torch.from_numpy(rng.rand(b, m).astype(np.float32))
    _, i1, _, i2 = ch.nn_distance_plain(a, c)
    return a, c, i1, i2, g1, g2


@pytest.mark.parametrize("kind,b,n,m", GRAD1_CASES)
def test_k3_bit_equal_to_the_ascending_j_sum(cuda, kind, b, n, m):
    """K3 against its plain version on the host, whose scatter sums run in
    ascending j as K3's do (tests/test_torch_ops_chamfer_ties.py pins it to
    an explicit loop): bit-equal on tie clouds and on x2 clustered on three
    x1 points, and a second run bit-equal to the first."""
    host_args = grad1_inputs(kind, b, n, m)
    host = ch.chamfer_grad1_plain(*host_args)
    args = [t.to(cuda) for t in host_args]
    first = cu.chamfer_grad1_cuda(*args)
    assert torch.equal(first.cpu(), host)
    assert torch.equal(cu.chamfer_grad1_cuda(*args), first)


@pytest.mark.parametrize("kind,b,n,m", GRAD1_CASES)
def test_k4_bit_equal_to_the_ascending_j_sum(cuda, kind, b, n, m):
    """K4, K3's segmented pass in K4's algebra, against its plain version
    on the host (pinned to an explicit ascending-j loop in
    tests/test_torch_ops_chamfer_ties.py): bit-equal on the same clouds as
    K3, and a second run bit-equal to the first."""
    host_args = grad1_inputs(kind, b, n, m)
    host = ch.chamfer_grad1_vpu_plain(*host_args)
    args = [t.to(cuda) for t in host_args]
    first = cu.chamfer_grad1_vpu_cuda(*args)
    assert torch.equal(first.cpu(), host)
    assert torch.equal(cu.chamfer_grad1_vpu_cuda(*args), first)


def unit_clouds(b, n, m, seed):
    """Uniform clouds with exact ties, the attack's scale: K4's algebra
    cancels x1 * cnt - sc, whose rounding grows with |x1| * cnt."""
    a, c = tie_clouds(b, n, m, seed)
    return a.abs() % 1.0, c.abs() % 1.0


@pytest.mark.parametrize("b,n,m", [(3, 37, 300), (2, 256, 256), (4, 257, 1000),
                                   (1, 1, 5), (2, 600, 20), (4, 2048, 2048),
                                   (2, 1100, 300)])
def test_k4_k5_k8_match_plain_versions(cuda, b, n, m):
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier

    a, c = (t.to(cuda) for t in unit_clouds(b, n, m, seed=n + m))
    k1 = cu.nn_distance_cuda(a, c)
    got = cu.chamfer_loss_payloads_cuda(a, c)
    want = ch.chamfer_loss_payloads_plain(a, c)
    for k in range(4):
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], k1[k])
    assert torch.equal(got[4], ch._take_points(c, got[1]))
    assert (got[5] - want[5]).abs().max().item() <= 1e-5
    assert torch.equal(got[6], want[6])

    gen = torch.Generator().manual_seed(b)
    g1 = torch.rand(b, n, generator=gen).to(cuda)
    g2 = torch.rand(b, m, generator=gen).to(cuda)
    grad_args = (a, c, k1[1], k1[3], g1, g2)
    k4 = cu.chamfer_grad1_vpu_cuda(*grad_args)
    k3 = cu.chamfer_grad1_cuda(*grad_args)
    # the plain version on the host sums the scatter terms in ascending j,
    # as K4 does (on the card its atomic scatter sums in another order)
    p4 = ch.chamfer_grad1_vpu_plain(*(t.cpu() for t in grad_args))
    assert torch.equal(k4.cpu(), p4)
    assert (k4 - k3).abs().max().item() <= GRAD_TOL

    cu.reset_launch_counts()
    for g, w in zip(hier.nn_distance_hier(a, c), k1):
        assert torch.equal(g, w)
    counts = cu.launch_counts()
    assert counts["hier_prep_cuda"] == 1 and counts["nn_direction_hier_cuda"] == 1
    (a4, cyr_a), (c4, cyr_c) = hier.prepare(a, c)
    dirs = [(a4, c4, cyr_c), (c4, a4, cyr_a)]
    for (kd, ki), d in zip(cu.nn_direction_hier_cuda(dirs), dirs):
        pd, pi = hier.nn_direction_hier_plain(*d)
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
    ((vd, vi),) = cu.nn_direction_hier_cuda([(a, c4, cyr_c)], with_idx=False)
    assert vi is None and torch.equal(vd, k1[0])


def prep_clouds(b, n, seed):
    """Uniform clouds with equal Morton codes (a duplicated point, a near
    copy in the same cell) and, in the last cloud, a flat axis (the box's
    clamp to 1e-12)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, n, 3).astype(np.float32)
    if n > 40:
        x[:, 40] = x[:, 3]
        x[:, 20] = x[:, 3] + np.float32(1e-6)
    x[-1, :, 2] = 0.25
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [1, 5, 127, 129, 2000, 2048, 2500, 16385, 40000])
def test_hier_prep_matches_the_plain_preparation(cuda, n):
    """The preparation kernel, one launch for two batches, against the plain
    torch preparation: codes, order and sorted cloud equal, centres equal,
    radii within 1 ulp (torch sums |p - c|^2 in its own order). Past
    PREP_CAP (16385, 40000) the sort merges through global memory."""
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier

    x, y = prep_clouds(3, n, seed=n).to(cuda), prep_clouds(3, 300, seed=n + 1).to(cuda)
    cu.reset_launch_counts()
    got = cu.hier_prep_cuda(x, y, with_codes=True)
    assert cu.launch_counts()["hier_prep_cuda"] == 1
    for pts, (pts4, cyr, codes) in zip((x, y), got):
        want4, want_cyr = hier.prepare_plain(pts)
        assert torch.equal(codes, hier.morton_codes(pts).to(torch.int32))
        assert torch.equal(hier.cloud_ids(pts4), hier.cloud_ids(want4))
        assert torch.equal(pts4[..., :3], want4[..., :3])
        assert torch.equal(cyr[..., :3], want_cyr[..., :3])
        ulp = torch.nextafter(want_cyr[..., 3], torch.tensor(np.inf, device=cuda))
        assert ((cyr[..., 3] - want_cyr[..., 3]).abs() <= ulp - want_cyr[..., 3]).all()
    ((alone, alone_cyr, none),) = cu.hier_prep_cuda(x)
    assert none is None and torch.equal(alone, got[0][0]) and torch.equal(alone_cyr, got[0][1])


def test_nn_distance_hier_past_the_preparation_cap(cuda):
    """Past PREP_CAP points the preparation kernel's sort merges through
    global memory (one call of its wrapper) and K8 runs once, bit-equal to
    K1."""
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier

    a, c = (t.to(cuda) for t in unit_clouds(1, hier.PREP_CAP + 1, 300, seed=13))
    cu.reset_launch_counts()
    got = hier.nn_distance_hier(a, c)
    counts = cu.launch_counts()
    assert counts["hier_prep_cuda"] == 1 and counts["nn_direction_hier_cuda"] == 1
    for g, w in zip(got, cu.nn_distance_cuda(a, c)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,n,m", [(4, 2048, 2048), (2, 300, 5000), (2, 4500, 129),
                                   (1, 33, 8193)])
def test_nn_distance_hier_across_staged_chunks(cuda, b, n, m):
    """K8 bit-equal to K1 where the other cloud takes more than one staged
    chunk of 4096 points (then a barrier per chunk), and where it fits."""
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier

    a, c = (t.to(cuda) for t in unit_clouds(b, n, m, seed=n + m))
    for g, w in zip(hier.nn_distance_hier(a, c), cu.nn_distance_cuda(a, c)):
        assert torch.equal(g, w)


def test_k8_nan_rule_matches_the_plain_version(cuda):
    """A query with a NaN coordinate gets NaN and index 2^30; a NaN point of
    the other cloud is never taken; the kernel as its plain version."""
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier

    a, c = (t.to(cuda) for t in unit_clouds(2, 300, 257, seed=17))
    a[1, 33, 1] = float("nan")
    ((c4, cyr),) = hier.prepare(c)
    c4[0, 30, :3] = float("nan")
    ((kd, ki),) = cu.nn_direction_hier_cuda([(a, c4, cyr)])
    pd, pi = hier.nn_direction_hier_plain(a, c4, cyr)
    assert torch.isnan(kd[1, 33]) and ki[1, 33] == 2**30
    assert torch.equal(torch.isnan(kd), torch.isnan(pd)) and torch.equal(ki, pi)
    keep = ~torch.isnan(pd)
    assert torch.equal(kd[keep], pd[keep])
    assert not (ki[0] == hier.cloud_ids(c4)[0, 30]).any()


def test_fused_loss_on_card_goes_through_k5(cuda):
    a, c = unit_clouds(2, 100, 90, seed=7)
    ta = a.to(cuda).requires_grad_(True)
    tc = c.to(cuda).requires_grad_(True)
    cu.reset_launch_counts()
    ch.chamfer_loss_per_pc(ta, tc, method="fused").sum().backward()
    with torch.no_grad():
        ch.chamfer_loss_per_pc(ta, tc, method="fused")
    torch.cuda.synchronize()
    counts = cu.launch_counts()
    assert counts["chamfer_loss_payloads_cuda"] == 1
    assert counts["nn_distance_cuda"] == 0
    assert counts["chamfer_grad1_cuda"] == 1  # the second cloud's gradient
    assert counts["nn_distance_values_cuda"] == 1  # the no-grad call (K2, both directions)
    ha, hc = a.clone().requires_grad_(True), c.clone().requires_grad_(True)
    ch.chamfer_loss_per_pc(ha, hc, method="fused").sum().backward()
    assert (ta.grad.cpu() - ha.grad).abs().max().item() <= GRAD_TOL
    assert (tc.grad.cpu() - hc.grad).abs().max().item() <= GRAD_TOL
    cu.reset_launch_counts()
    small = a.to(cuda).requires_grad_(True)
    ch.chamfer_loss_per_pc(small, c.to(cuda)).sum().backward()  # auto, n <= 1024
    assert cu.launch_counts()["chamfer_loss_payloads_cuda"] == 1


def test_frozen_attack_on_card_goes_through_k5_past_2048_points(cuda):
    """The frozen payloads take K5 at any n (the fused loss's n <= 2048 gate
    is routing, not a limit of K5): a frozen attack at 2100 points launches
    K5 on the refresh schedule and K1, K2, K3 never, and agrees with the same
    attack on the host."""
    from geometric_adv_tpu_torch.attack.core import attack_batch

    a, c = unit_clouds(2, 2100, 2100, seed=11)
    x1, x2 = a.to(cuda), c.to(cuda)
    cu.reset_launch_counts()
    got = ch.chamfer_frozen_payloads(x1, x2)
    assert cu.launch_counts()["chamfer_loss_payloads_cuda"] == 1
    want = ch.chamfer_frozen_payloads(a, c)
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 3:  # snn1
            assert (g.cpu() - w).abs().max().item() <= 1e-5
        else:
            assert torch.equal(g.cpu(), w)

    def encode(x):  # a stand-in victim: the cloud is its own latent
        return x

    def decode(z):
        return 0.9 * z

    outs = {}
    for name, dev in (("card", cuda), ("host", torch.device("cpu"))):
        x, gt = (t.to(dev) for t in (a, c))
        cu.reset_launch_counts()
        outs[name] = attack_batch(
            encode, decode, x, x.mean(dim=1), gt, torch.ones(2, device=dev), [1.0],
            num_iterations=5, num_iterations_thresh=1, chamfer_refresh=2)
        if name == "card":
            counts = cu.launch_counts()
    # steps 0..5 in chunks of 2: three refreshes of two chamfers
    assert counts["chamfer_loss_payloads_cuda"] == 6
    assert counts["nn_distance_cuda"] == counts["nn_distance_values_cuda"] == 0
    assert counts["chamfer_grad1_cuda"] == 0
    np.testing.assert_allclose(outs["card"].metrics, outs["host"].metrics,
                               rtol=1e-3, atol=1e-5)


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
    with pytest.raises(TypeError):
        cu.chamfer_grad1_vpu_cuda(a, c, i1, i2.long(), g1, g2)
    with pytest.raises(ValueError):
        cu.chamfer_loss_payloads_cuda(a, c.cpu())
    cyr = torch.zeros(2, 1, 4, device=cuda)
    c4 = torch.zeros(2, 40, 4, device=cuda)
    with pytest.raises(ValueError):
        cu.nn_direction_hier_cuda([(a, c4, cyr[:, :, :3].contiguous())])
    with pytest.raises(ValueError):
        cu.nn_direction_hier_cuda([(a, c, cyr)])
    with pytest.raises(ValueError):
        cu.hier_prep_cuda(torch.zeros(1, 40, 3))
    with pytest.raises(RuntimeError):  # the spheres of 1.4e6 points do not fit
        m = 11000 * 128
        cu.nn_direction_hier_cuda([(a[:1], torch.zeros(1, m, 4, device=cuda),
                                    torch.zeros(1, m // 128, 4, device=cuda))])


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


@pytest.mark.parametrize("b,n,m", [(1, 1, 5), (2, 127, 129), (2, 128, 128), (2, 129, 1024),
                                   (4, 1000, 513), (8, 1024, 512), (24, 1024, 1024)])
def test_k6_at_the_cluster_split_edges(cuda, b, n, m):
    """K6 splits a pair over ceil(max(n, m) / 128) blocks: one block, two,
    eight with rows but no columns (and the reverse), at the EMD attack's
    [24, 1024^2]. Against the plain sweep in all four modes, value-only
    cost bit-equal; a second run bit-equal to the first; every output
    bit-equal to K7's (the same gradient sums in the same order; the
    per-row costs added in float64 in another order, then rounded)."""
    a, c = (t.to(cuda) for t in emd_clouds(b, n, m, seed=b + n + m))
    want = emd.emd_sweep_plain(a, c, True, True)
    full = cu_emd.emd_sweep_block_cuda(a, c, emd._LEVELS, True, True)
    for flags in ((True, True), (True, False), (False, True), (False, False)):
        first = cu_emd.emd_sweep_block_cuda(a, c, emd._LEVELS, *flags)
        again = cu_emd.emd_sweep_block_cuda(a, c, emd._LEVELS, *flags)
        torch.cuda.synchronize()
        assert torch.equal(first[0], full[0])
        assert_sweep_close(first, want)
        for f, g in zip(first, again):
            assert (f is None) == (g is None)
            if f is not None:
                assert torch.equal(f, g)
    tiled = cu_emd.emd_sweep_tiled_cuda(a, c, emd._LEVELS, True, True)
    assert all(torch.equal(f, g) for f, g in zip(full, tiled))


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
    with pytest.raises(ValueError):
        cu_emd.emd_sweep_tiled_cuda(a, c, emd._LEVELS, True, True,
                                    skip_counts=torch.zeros(3, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("b,n,m", [(24, 2048, 2048), (3, 2500, 2048)])
def test_k7_repeats_keep_every_bit(cuda, b, n, m):
    """K7 in g1 mode (the attack's call) and in grads mode: a second run
    bit-equal to the first."""
    a, c = (t.to(cuda) for t in emd_clouds(b, n, m, seed=b + n))
    for flags in ((True, False), (True, True)):
        first = cu_emd.emd_sweep_tiled_cuda(a, c, emd._LEVELS, *flags)
        again = cu_emd.emd_sweep_tiled_cuda(a, c, emd._LEVELS, *flags)
        for g, w in zip(again, first):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)


def test_k7_skips_and_their_numerics(cuda):
    """The card's expf is +0 exactly below EXP_UNDERFLOW over [-110, -100],
    and K7's square root from the gradient's rsqrt is sqrtf's over
    [1e-20, FLT_MAX]; K7 skips most (warp, element) pairs at the highest
    level and none at level 0."""
    scan = cu_emd.numerics_scan(cuda)
    assert scan["expf_mismatches"] == 0 and scan["sqrt_mismatches"] == 0
    assert scan["most_negative_positive"] == cu_emd.EXP_UNDERFLOW
    assert scan["least_negative_zero"] < cu_emd.EXP_UNDERFLOW
    a, c = (t.to(cuda) for t in emd_clouds(2, 512, 640, seed=9))
    counts = torch.zeros(len(emd._LEVELS), 3, dtype=torch.int64, device=cuda)
    cu_emd.emd_sweep_tiled_cuda(a, c, emd._LEVELS, True, True, skip_counts=counts)
    pairs = torch.tensor([2 * 640 // 32 * 512, 2 * 512 // 32 * 640, 2 * 512 // 32 * 640],
                         dtype=torch.float64)
    share = counts.cpu().double() / pairs
    assert share[0].min() > 0.3 and (share[-1] == 0).all()
    assert (share <= 1).all()


def surface_batch(b, n, seed):
    from geometric_adv_tpu_torch.data.synthetic import SHAPE_CLASSES, sample_shape

    rng = np.random.RandomState(seed)
    return torch.from_numpy(np.stack([
        sample_shape(SHAPE_CLASSES[i % len(SHAPE_CLASSES)], n, rng) for i in range(b)
    ]).astype(np.float32))


@pytest.mark.parametrize("b,n,k", [(4, 2048, 9), (3, 300, 300), (100, 2048, 9)])
def test_knn_point_on_card_bit_equal_to_host(cuda, b, n, k):
    """The defense's kNN (k + 1 against itself) on the card: distances and
    indices bit-equal to the host's; at [100, 2048^2] in blocks of queries."""
    from geometric_adv_tpu_torch.ops.grouping import knn_point

    pcs = surface_batch(b, n, seed=b)
    pcs[:, 1] = pcs[:, 9]
    if b == 100:  # the host's plane at this size is slow: check 4 clouds
        host = knn_point(k, pcs[:4], pcs[:4])
        card = knn_point(k, pcs.to(cuda), pcs.to(cuda))
        card = tuple(t[:4] for t in card)
    else:
        host = knn_point(k, pcs, pcs)
        card = knn_point(k, pcs.to(cuda), pcs.to(cuda))
    for g, w in zip(card, host):
        assert torch.equal(g.cpu(), w)


def test_screened_matrix_on_card_matches_host(cuda):
    """The chunk-screened matrix on the card within the CPU tests' bar of
    the host's (rtol 1e-6, atol 1e-7), every entry >= the card's exact one,
    and with k = C equal to it at rtol 1e-6."""
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix

    pcs = surface_batch(12, 2048, seed=3).numpy()
    host = chamfer_distance_matrix(pcs, "cpu", screen_chunks=64, screen_k=8)
    card = chamfer_distance_matrix(pcs, cuda, screen_chunks=64, screen_k=8)
    np.testing.assert_allclose(card, host, rtol=1e-6, atol=1e-7)
    exact = chamfer_distance_matrix(pcs, cuda)
    assert np.all(card >= exact)
    full = chamfer_distance_matrix(pcs[:4], cuda, screen_chunks=64, screen_k=64)
    np.testing.assert_allclose(full, exact[:4, :4], rtol=1e-6, atol=0)


def test_pre_symmetry_argmax_on_card_matches_host(cuda):
    """get_pre_symmetry_argmax on the card against the host's on channels
    whose maximum leads the runner-up by more than 1e-4 of it (the card's
    and the host's GEMMs round differently); most channels qualify."""
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    host = AETrainer(Configuration(n_input=[2048, 3]), "cpu")
    card = AETrainer(Configuration(n_input=[2048, 3]), cuda)
    card.model.load_state_dict(host.model.state_dict())
    pcs = surface_batch(12, 2048, seed=4).numpy()
    want_idx, want_val = host.get_pre_symmetry_argmax(pcs, batch_size=5)
    got_idx, got_val = card.get_pre_symmetry_argmax(pcs, batch_size=5)
    pre = host.get_pre_symmetry_data(pcs, batch_size=5)
    top2 = np.sort(pre, axis=1)[:, -2:]
    separated = (top2[:, 1] - top2[:, 0]) > 1e-4 * np.abs(top2[:, 1])
    assert separated.mean() > 0.5
    np.testing.assert_array_equal(got_idx[separated], want_idx[separated])
    np.testing.assert_allclose(got_val, want_val, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,n,m", [(1, 30000, 30000), (2, 5000, 7000)])
def test_k2_at_the_metro_shapes_matches_its_chunked_plain_version(cuda, b, n, m):
    """K2 at metro's shapes, where a block's rows outgrow its shared memory
    and the x2 loop runs several chunks: bit-equal to its plain version in
    row chunks (a minimum is exact in any order), a second run too."""
    from geometric_adv_tpu_torch.transfer import metro

    a, c = (t.to(cuda) for t in tie_clouds(b, n, m, seed=n + m))
    got = cu.nn_distance_values_cuda(a, c)
    for g, w in zip(got, metro.nn_distance_values_chunked(a, c, 2048)):
        assert torch.equal(g, w)
    for g, w in zip(cu.nn_distance_values_cuda(a, c), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [2500, 2025])
def test_k1_k3_at_the_transfer_shapes(cuda, n):
    """K1 and K3 at AtlasNet's (2500) and FoldingNet's (2025) loss against
    2048-point clouds: K1 bit-equal to its plain version, K3 bit-equal to
    the host's ascending-j sums and within GRAD_TOL of the card's plain
    version."""
    a, c = (t.to(cuda) for t in tie_clouds(16, n, 2048, seed=n))
    got = cu.nn_distance_cuda(a, c)
    for g, w in zip(got, ch.nn_distance_plain(a, c)):
        assert torch.equal(g, w)
    gen = torch.Generator().manual_seed(n)
    args = (a, c, got[1], got[3], torch.rand(16, n, generator=gen).to(cuda),
            torch.rand(16, 2048, generator=gen).to(cuda))
    k3 = cu.chamfer_grad1_cuda(*args)
    assert torch.equal(k3.cpu(), ch.chamfer_grad1_plain(*(t.cpu() for t in args)))
    assert (k3 - ch.chamfer_grad1_plain(*args)).abs().max().item() <= GRAD_TOL


def test_metro_hausdorff_on_the_card_matches_the_host(cuda):
    """hausdorff_sampled through K2 on the card equals the host's chunked
    plain route on the same samples."""
    from geometric_adv_tpu_torch.transfer import metro

    verts = np.random.RandomState(0).rand(4, 25, 3).astype(np.float32)
    mesh = metro.merge_patch_meshes(verts, metro.square_grid_faces(5))
    gen = torch.Generator(device=cuda).manual_seed(3)
    s1 = metro.sample_mesh_surface(*mesh, 3000, gen, cuda)
    s2 = metro.sample_mesh_surface(*mesh, 2000, gen, cuda)
    before = cu.nn_distance_values_cuda.launches
    card = metro.hausdorff_sampled(s1, s2)
    assert cu.nn_distance_values_cuda.launches == before + 1
    assert float(card) == float(metro.hausdorff_sampled(s1.cpu(), s2.cpu()))


def _victim(cuda, n, bneck, enc, dec, dtype="float32", seed=0):
    from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE, init_weights

    model = PointNetAE(n_points=n, bneck_size=bneck, encoder_filters=enc,
                       decoder_sizes=dec, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # BN statistics away from their init
        for buf in model.buffers():
            buf.add_(0.3 * buf.abs() + 0.01)
    return model.to(cuda).eval().requires_grad_(False)


@pytest.mark.parametrize("scatter_impl", ["onehot", "scatter"])
def test_sparse_encode_on_card(cuda, scatter_impl, monkeypatch):
    """The sparse encoder VJP on the card: z bit-equal to the dense encode,
    the gradient against dense autograd (elementwise rtol 2e-5 / atol 1e-7
    at tests/test_sparse_encode.py's victim, 2e-5 of the largest entry at
    the full width), the "onehot" return bit-equal on a second run."""
    from geometric_adv_tpu_torch.cli.verify_cuda import SPARSE_SCALED, sparse_vs_dense
    from geometric_adv_tpu_torch.models import sparse_encode

    monkeypatch.setattr(sparse_encode, "SCATTER_IMPL", scatter_impl)
    rng = np.random.RandomState(1)
    small = _victim(cuda, 64, 16, [16, 32, 16], [16, 16])
    res = sparse_vs_dense(small, torch.from_numpy(rng.randn(5, 64, 3).astype(np.float32)).to(cuda))
    assert res["z_equal"] and res["elementwise"] and res["backward_calls"] == 1, res
    full = _victim(cuda, 2048, 128, None, None)
    x = torch.from_numpy(rng.rand(4, 2048, 3).astype(np.float32) - 0.5).to(cuda)
    res = sparse_vs_dense(full, x)
    assert res["z_equal"] and res["max_rel"] <= SPARSE_SCALED, res
    grads = []
    for _ in range(2):
        xr = x.clone().requires_grad_(True)
        sparse_encode.make_sparse_encode(full)(xr).sum().backward()
        grads.append(xr.grad)
    if scatter_impl == "onehot":
        assert torch.equal(grads[0], grads[1])
    else:  # index_add_ adds in the atomics' order
        torch.testing.assert_close(grads[0], grads[1], rtol=2e-5, atol=1e-7)


def test_argmax_takes_the_first_tied_maximum_on_card(cuda):
    t = torch.zeros(3, 2048, 128, device=cuda)
    t[:, [1999, 9, 700]] = 2.0
    assert (t.argmax(dim=-2) == 9).all()
    assert (t.amax(dim=-2) == 2.0).all()


def test_bf16_victim_on_card_matches_host(cuda):
    """The bfloat16 victim on the card against the same victim on the host:
    within one bfloat16 step (2^-8) of the largest entry, as
    tests/test_torch_precision.py holds it against JAX's."""
    model = _victim(cuda, 256, 128, None, None, dtype="bfloat16")
    host = _victim(torch.device("cpu"), 256, 128, None, None, dtype="bfloat16")
    x = np.random.RandomState(2).randn(4, 256, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(cuda))
        want = host(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().cpu().numpy(), w.float().numpy()
        assert np.abs(g - w).max() <= 2.0 ** -8 * np.abs(w).max()


def test_matmul_precision_sets_tf32_on_card(cuda):
    from geometric_adv_tpu_torch.cli import common

    try:
        for precision, tf32 in (("tensorfloat32", True), ("bfloat16", True),
                                ("highest", False), (None, False)):
            common.resolve_device("cuda", precision)
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        common.resolve_device("cuda")
