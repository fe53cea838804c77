"""The port's fused chamfer loss, its payloads (K5's plain version), the
frozen-mode payloads and K4's plain version, against the JAX package on the
CPU.

JAX's Pallas kernels run in interpreter mode, as tests/test_ops_chamfer.py
runs them. Bars: indices, nn1 and cnt1 equal and snn1 rtol 1e-6 / atol
1e-7 (tests/test_ops_chamfer.py:133-201); distances and the fused loss
within 2 ulp of the interpreter, whose XLA:CPU code contracts the distance
into FMAs (tests/test_ops_chamfer.py:294-296), and bit-equal to the port's
composed route; gradients atol 1e-6; K4 atol 2.6e-6 (DESIGN.md section 6); the
frozen payloads at tests/test_attack.py:583-614's bars; three chamfer train
steps at 1024 points, fused against composed, losses rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import geometric_adv_tpu.ops.chamfer as jchamfer
from geometric_adv_tpu_torch.ops import chamfer as tchamfer

GRAD_TOL = 2.6e-6


def tie_clouds(seed, b, n, m):
    """tests/test_ops_chamfer.py:143-146's clouds: duplicates on both sides."""
    rng = np.random.RandomState(seed)
    x1 = rng.randn(b, n, 3).astype(np.float32)
    x2 = rng.randn(b, m, 3).astype(np.float32)
    x2[:, 5] = x2[:, 17]
    x1[:, 9] = x1[:, 40]
    return x1, x2


def second_subtile_clouds():
    """tests/test_ops_chamfer.py:177-181: n pads above 1024, a column's
    nearest point in the second subtile, a cross-subtile duplicate."""
    x1, x2 = tie_clouds(7, 1, 1100, 300)
    x1[0, 1050] = x2[0, 7] + 1e-3
    x1[0, 9] = x1[0, 1040]
    return x1, x2


CLOUDS = {"70x50": lambda: tie_clouds(0, 2, 70, 50), "1100x300": second_subtile_clouds}


@pytest.fixture(autouse=True)
def _restore_switch():
    saved = tchamfer.FUSED_LOSS_ENABLED
    yield
    tchamfer.FUSED_LOSS_ENABLED = saved


@pytest.mark.parametrize("case", list(CLOUDS))
def test_payloads_plain_match_jax_kernel(case):
    from geometric_adv_tpu.ops.pallas.chamfer_loss_kernel import chamfer_loss_payloads

    x1, x2 = CLOUDS[case]()
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in chamfer_loss_payloads(x1, x2)]
    got = [t.numpy() for t in tchamfer.chamfer_loss_payloads_plain(
        torch.from_numpy(x1), torch.from_numpy(x2))]
    names = ("d1", "i1", "d2", "i2", "nn1", "snn1", "cnt1")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name == "snn1":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)
        elif name in ("d1", "d2"):
            # XLA:CPU contracts the interpreter's mul/add chain into FMAs
            # (tests/test_ops_chamfer.py:294-296); the port rounds each
            # product and sum, as the CUDA kernels do
            np.testing.assert_array_max_ulp(g, w, maxulp=2)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # the plain version holds the same bits as the composed op
    d1, i1, d2, i2 = tchamfer.nn_distance_plain(torch.from_numpy(x1),
                                                torch.from_numpy(x2))
    for g, w in zip(got[:4], (d1, i1, d2, i2)):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_array_equal(got[4], np.take_along_axis(
        x2, got[1][..., None].astype(np.int64), axis=1))


@pytest.mark.parametrize("case", list(CLOUDS))
def test_fused_loss_matches_jax_fused_kernel(case):
    from geometric_adv_tpu.ops.chamfer import _chamfer_per_pc_fused

    x1, x2 = CLOUDS[case]()
    w = np.random.RandomState(3).rand(x1.shape[0]).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_chamfer_per_pc_fused(x1, x2))
        jg1, jg2 = jax.grad(lambda a, b: jnp.sum(_chamfer_per_pc_fused(a, b) * w),
                            argnums=(0, 1))(x1, x2)
    t1 = torch.from_numpy(x1).requires_grad_(True)
    t2 = torch.from_numpy(x2).requires_grad_(True)
    loss = tchamfer.chamfer_loss_per_pc(t1, t2, method="fused")
    (loss * torch.from_numpy(w)).sum().backward()
    # the distances' FMA contraction in the interpreter, carried into the
    # means (bit-equal to the port's composed route below)
    np.testing.assert_array_max_ulp(loss.detach().numpy(), want, maxulp=2)
    np.testing.assert_array_equal(
        loss.detach().numpy(),
        tchamfer.chamfer_loss_per_pc(torch.from_numpy(x1), torch.from_numpy(x2),
                                     method="composed").numpy())
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(jg1), atol=1e-6)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(jg2), atol=1e-6)
    # and the composed route's gradients
    c1 = torch.from_numpy(x1).requires_grad_(True)
    c2 = torch.from_numpy(x2).requires_grad_(True)
    (tchamfer.chamfer_loss_per_pc(c1, c2, method="composed")
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), c1.grad.numpy(), atol=1e-6)
    np.testing.assert_allclose(t2.grad.numpy(), c2.grad.numpy(), atol=1e-6)


@pytest.mark.parametrize("enabled", [None, True, False])
def test_routing_gates_match_jax(enabled, monkeypatch):
    monkeypatch.setattr(jchamfer, "FUSED_LOSS_ENABLED", enabled)
    tchamfer.FUSED_LOSS_ENABLED = enabled
    for n in (1, 255, 256, 257, 700, 1024, 1025, 1280, 2047, 2048, 2049, 4096):
        assert tchamfer._fused_loss_shape_ok(n) == jchamfer._fused_loss_shape_ok(n)
        assert tchamfer._fused_loss_supported(n) == jchamfer._fused_loss_supported(n)


def test_routing_on_the_cpu(monkeypatch):
    """auto stays composed on the CPU; fused takes K5's plain version where
    the gate allows; a fused call without gradients takes K2's route."""
    calls = []
    for name in ("chamfer_loss_payloads_plain", "nn_distance_values_plain",
                 "nn_distance_plain"):
        fn = getattr(tchamfer, name)
        monkeypatch.setattr(tchamfer, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    x1, x2 = (torch.from_numpy(a) for a in tie_clouds(1, 2, 64, 40))
    grad_x1 = x1.clone().requires_grad_(True)

    def route(*args, **kw):
        calls.clear()
        tchamfer.chamfer_loss_per_pc(*args, **kw)
        return calls[0]

    assert route(grad_x1, x2) == "nn_distance_plain"
    assert route(grad_x1, x2, method="composed") == "nn_distance_plain"
    assert route(grad_x1, x2, method="fused") == "chamfer_loss_payloads_plain"
    assert route(x1, x2, method="fused") == "nn_distance_values_plain"
    with torch.no_grad():
        assert route(grad_x1, x2, method="fused") == "nn_distance_values_plain"
    big = torch.zeros(1, 2049, 3, requires_grad=True)
    assert route(big, x2[:1], method="fused") == "nn_distance_plain"
    tchamfer.FUSED_LOSS_ENABLED = True
    assert route(grad_x1, x2) == "chamfer_loss_payloads_plain"
    tchamfer.FUSED_LOSS_ENABLED = False
    assert route(grad_x1, x2) == "nn_distance_plain"
    with pytest.raises(ValueError):
        tchamfer.chamfer_loss_per_pc(x1, x2, method="mxu")
    # values agree across the routes
    tchamfer.FUSED_LOSS_ENABLED = None
    outs = [tchamfer.chamfer_loss_per_pc(grad_x1, x2, method=m).detach()
            for m in ("auto", "fused", "composed")]
    outs.append(tchamfer.chamfer_loss_per_pc(x1, x2, method="fused"))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("b,n,m", [(2, 17, 23), (2, 23, 17), (1, 2050, 16)])
def test_frozen_payloads_match_jax_and_a_loop(b, n, m):
    """At any n, past the fused loss's gate too: the payloads are K5's
    (its plain version here) at every size."""
    rng = np.random.RandomState(11)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    got = [t.numpy() for t in tchamfer.chamfer_frozen_payloads(
        torch.from_numpy(x1), torch.from_numpy(x2))]
    want = [np.asarray(a) for a in jchamfer.chamfer_frozen_payloads(
        jnp.asarray(x1), jnp.asarray(x2), "composed")]
    _, i1, _, i2 = jchamfer.nn_distance(x1, x2)
    i1, i2 = np.asarray(i1), np.asarray(i2)
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 3:  # snn1
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w)
    for bi in range(b):
        np.testing.assert_array_equal(got[2][bi], x2[bi][i1[bi]])
        snn = np.zeros((n, 3), np.float32)
        cnt = np.zeros(n, np.float32)
        for j in range(m):
            snn[i2[bi, j]] += x2[bi, j]
            cnt[i2[bi, j]] += 1.0
        np.testing.assert_allclose(got[3][bi], snn, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got[4][bi], cnt)


@pytest.mark.parametrize("n,m,unit", [(70, 50, False), (128, 512, True),
                                      (2048, 2048, "ties")])
def test_grad1_vpu_plain_matches_jax_kernel_and_k3(n, m, unit):
    """K4 factors x1 out of the scatter term, so x1*cnt - sc cancels: the
    error grows with |x1| * cnt. At (45, 300) with standard-normal clouds
    (cnt up to 17) the plain version is 4.4e-6 from a float64 evaluation,
    JAX's interpreted kernel 2.2e-6; the bar holds at the attack's scale,
    unit-cube clouds with cnt up to 12, at tests/test_ops_chamfer.py's
    (70, 50), and on unit-cube clouds whose exact ties straddle the
    kernels' tiles, blocks and steps (tests/test_torch_ops_chamfer_ties.py)."""
    from geometric_adv_tpu.ops.pallas.chamfer_bwd_kernel import (
        chamfer_grad1_pallas_vpu,
    )
    from test_torch_ops_chamfer_ties import straddling_ties

    if unit == "ties":
        x1, x2 = straddling_ties(2, n, m, seed=n + m)
    else:
        x1, x2 = tie_clouds(n + m, 2, n, m)
    if unit is True:
        x1, x2 = (np.abs(a) % 1.0 for a in (x1, x2))
    rng = np.random.RandomState(n)
    g1 = rng.rand(2, n).astype(np.float32)
    g2 = rng.rand(2, m).astype(np.float32)
    _, i1, _, i2 = (np.asarray(a) for a in jchamfer.nn_distance(x1, x2, "direct"))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(chamfer_grad1_pallas_vpu(x1, x2, i1, i2, g1, g2))
    args = [torch.from_numpy(a) for a in (x1, x2, i1, i2, g1, g2)]
    got = tchamfer.chamfer_grad1_vpu_plain(*args)
    assert torch.equal(tchamfer.chamfer_grad1_vpu(*args), got)
    np.testing.assert_allclose(got.numpy(), want, atol=GRAD_TOL)
    np.testing.assert_allclose(got.numpy(), tchamfer.chamfer_grad1_plain(*args).numpy(),
                               atol=GRAD_TOL)


def test_fused_train_steps_at_1024_points_match_composed():
    """Three chamfer train steps at 1024 points from bridged JAX weights:
    the port with FUSED_LOSS_ENABLED=True (K5's plain version inside the
    fused Function) against the port's composed route, and both against
    the JAX trainer (its CPU route is composed) at the train test's bar."""
    from geometric_adv_tpu.train import AETrainer as JaxTrainer
    from geometric_adv_tpu.train import Configuration as JaxConfiguration
    from geometric_adv_tpu_torch.data.synthetic import sample_shape
    from geometric_adv_tpu_torch.models.bridge import state_dict_from_flax
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    rng = np.random.RandomState(5)
    pcs = np.stack([sample_shape(("sphere", "cube", "torus")[i % 3], 1024, rng)
                    for i in range(24)]).astype(np.float32)
    kw = dict(n_input=[1024, 3], bneck_size=16, encoder_filters=[16, 32, 16],
              decoder_sizes=[32, 32], batch_size=8, learning_rate=0.005,
              loss="chamfer")
    losses = {}
    for enabled in (True, None):
        tchamfer.FUSED_LOSS_ENABLED = enabled
        jt = JaxTrainer(JaxConfiguration(**kw))
        pt = AETrainer(Configuration(**kw), "cpu")
        pt.model.load_state_dict(state_dict_from_flax(
            jax.tree.map(np.asarray, jt.state.params),
            jax.tree.map(np.asarray, jt.state.batch_stats)))
        rows = []
        for step in range(3):
            x = pcs[8 * step: 8 * step + 8]
            jt.state, jloss, _ = jt._jit_train_step(jt.state, x, x)
            ploss, _ = pt._train_step(torch.from_numpy(x), torch.from_numpy(x))
            rows.append((float(ploss), float(jloss)))
        losses[enabled] = np.array(rows)
    np.testing.assert_allclose(losses[True][:, 0], losses[None][:, 0], rtol=1e-6)
    np.testing.assert_allclose(losses[True][:, 0], losses[True][:, 1], rtol=1e-5)
