"""On-card verification of what the CPU suite cannot see
(``geometric_adv_tpu/cli/verify_tpu.py``'s counterpart on CUDA).

Run on a machine with a CUDA card:

    python3 -m geometric_adv_tpu_torch.cli.verify_cuda

It prints one PASS/FAIL line per check and exits non-zero on any failure;
off the card it prints ``[FAIL] backend is CUDA`` and exits 1. The checks
are the TPU list's that have a meaning on the card:

1. the backend is CUDA;
2. K1 (``nn_distance``) equals its plain version on the card, values bit for
   bit and indices at the first tie, on clouds of 1000 x 900 points with
   planted ties;
3. K5's distances and indices equal K1's;
4. the fused and the composed chamfer loss: same values and input gradients;
   K4 (the VPU algebra) against K3;
5. the sparse encoder VJP (``models/sparse_encode.py``): forward bit-equal
   to ``PointNetAE.encode``; the input gradient against dense autograd at
   the JAX test's bar, elementwise rtol 2e-5 / atol 1e-7, on the JAX test's
   victim (64 points, encoder [16, 32, 16]), and at the full width (256
   points, encoder [64, 128, 128, 256, 128]) within 2e-5 of the gradient's
   largest entry (``SPARSE_SCALED``); the recomputed masks' flips printed;
   ``argmax`` takes the first of tied maxima on the card;
6. a 25-iteration attack, sparse against dense encoder VJP: at the JAX
   test's bar (rtol 2e-4 / atol 1e-6) on its victim, and at the full width
   within 10x the drift of a dense run from sources one ulp away; ``auto``
   taking the dense path;
7. ``AttackRunner``'s calibration runs and routes the measured winner, and
   a second runner at another shape calibrates on its own;
8. the EMD sweep (``emd_loss_fused``) against ``match_cost(approx_match())``
   in value and gradient;
9. the frozen payloads: K5 against its plain version on the card, and the
   frozen forms at delta = 0 against the exact chamfer loss and gradient;
10. K6 admitted at 512 x 448 and equal to the plain sweep in value and
    gradient;
11. metro's ``hausdorff_sampled`` at its 30,000 samples: K2 against the
    chunked plain route on the card;
12. the chunk-screened matrix at 2048 points: full coverage equals the
    exact matrix, k = 8 majorizes it.

``tie_clouds`` and ``sparse_vs_dense`` are also ``chip_smoke.py``'s.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

_FAILURES: list[str] = []
SPARSE_RTOL, SPARSE_ATOL = 2e-5, 1e-7  # tests/test_sparse_encode.py:74-75
# At the full width the float32 gradient of either path misses the
# elementwise bar against the float64 gradient itself (max error 2.9e-7 of
# the largest entry, yet entries off by more than rtol 1e-4 / atol 1e-6
# where the sum cancels; measured on the CPU): there the two paths are held
# to 2e-5 of the gradient's largest entry (they differ by 4.0e-7 of it).
SPARSE_SCALED = 2e-5


def _check(name: str, ok: bool, detail: str = "") -> None:
    status = "PASS" if ok else "FAIL"
    print(f"[{status}] {name}" + (f" — {detail}" if detail else ""), flush=True)
    if not ok:
        _FAILURES.append(name)


def tie_clouds(b, n, m, seed, device="cuda"):
    """Seeded uniform clouds with exact ties: a duplicated point in each
    cloud and a query point that coincides with a point of the other; at
    2048 points and more, ties that straddle K1's boundaries
    (tests/test_torch_ops_chamfer_ties.py): rows 3 and 1500 (other tiles
    and blocks) on column 7, columns 5 and 1800 (other steps) on row 40,
    rows 255/256 (a tile boundary) on column 300, columns 255/256 (a step
    boundary) on row 600, past 2048 rows also row 2100 on column 7."""
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, n, 3).astype(np.float32)
    x2 = rng.rand(b, m, 3).astype(np.float32)
    x2[:, 5] = x2[:, 17]
    x1[:, 9] = x1[:, 41]
    x1[:, 3] = x2[:, 7]
    if n >= 2048 and m >= 2048:
        x1[:, 1500] = x2[:, 7]
        x2[:, 1800] = x2[:, 5]
        x1[:, 40] = x2[:, 5]
        x1[:, 255] = x1[:, 256] = x2[:, 300]
        x2[:, 256] = x2[:, 255]
        x1[:, 600] = x2[:, 255]
        if n > 2100:
            x1[:, 2100] = x2[:, 7]
    return torch.from_numpy(x1).to(device), torch.from_numpy(x2).to(device)


def _scalarize(z: torch.Tensor) -> torch.Tensor:
    # every z channel gets a distinct cotangent (tests/test_sparse_encode.py)
    weights = torch.arange(1.0, 1.0 + z.shape[-1], device=z.device)
    return (torch.sin(z.float()) * weights).sum()


def sparse_vs_dense(model, x: torch.Tensor) -> dict:
    """The sparse encoder VJP against dense autograd on the eval-mode
    ``model`` at ``x``: {"z_equal": z bit-equal to ``model.encode``,
    "max_abs": the gradients' largest difference, "max_rel": that over the
    dense gradient's largest entry, "elementwise": within rtol 2e-5 / atol
    1e-7 entry by entry, "flips": ``sparse_encode.mask_flips``,
    "backward_calls": the sparse backward passes this ran}."""
    from geometric_adv_tpu_torch.models import sparse_encode

    sparse = sparse_encode.make_sparse_encode(model)
    calls = sparse_encode.BACKWARD_CALLS
    grads = {}
    for name, enc in (("sparse", sparse), ("dense", model.encode)):
        xr = x.detach().clone().requires_grad_(True)
        z = enc(xr)
        _scalarize(z).backward()
        grads[name] = (z.detach(), xr.grad)
    gs, gd = grads["sparse"][1], grads["dense"][1]
    return {
        "z_equal": bool(torch.equal(grads["sparse"][0], grads["dense"][0])),
        "max_abs": float((gs - gd).abs().max()),
        "max_rel": float((gs - gd).abs().max() / gd.abs().max().clamp_min(1e-30)),
        "elementwise": bool(torch.allclose(gs, gd, rtol=SPARSE_RTOL,
                                           atol=SPARSE_ATOL)),
        "flips": sparse_encode.mask_flips(model, x),
        "backward_calls": sparse_encode.BACKWARD_CALLS - calls,
    }


def _kernel_checks(dev):
    from geometric_adv_tpu_torch.ops import chamfer as ch

    x, y = tie_clouds(4, 1000, 900, seed=0, device=dev)
    k1 = ch.nn_distance(x, y)
    plain = ch.nn_distance_plain(x, y)
    _check("K1 == plain composition (values, bit for bit)",
           torch.equal(k1[0], plain[0]) and torch.equal(k1[2], plain[2]))
    _check("K1 == plain composition (argmin indices, first tie)",
           torch.equal(k1[1], plain[1]) and torch.equal(k1[3], plain[3]),
           f"i1 mismatches={int((k1[1] != plain[1]).sum())}, "
           f"i2 mismatches={int((k1[3] != plain[3]).sum())}")
    d1p, i1p, d2p, i2p = ch.chamfer_loss_payloads(x, y)[:4]
    _check("K5 distances and indices == K1",
           all(torch.equal(a, b) for a, b in zip((d1p, i1p, d2p, i2p), k1)))

    vf, gf = value_grad_at(x, lambda p: ch.chamfer_loss_per_pc(p, y, method="fused"))
    vc, gc = value_grad_at(x, lambda p: ch.chamfer_loss_per_pc(p, y, method="composed"))
    vf, vc = float(vf.sum()), float(vc.sum())
    _check("fused vs composed loss value", abs(vf - vc) <= 1e-6 * max(1.0, abs(vc)),
           f"|dv|={abs(vf - vc):.3g}")
    gd = float((gf - gc).abs().max())
    _check("fused vs composed loss gradient", gd <= 1e-6, f"max|dg|={gd:.3g}")
    g1 = torch.rand(4, 1000, device=dev)
    g2 = torch.rand(4, 900, device=dev)
    k3 = ch.chamfer_grad1(x, y, k1[1], k1[3], g1, g2)
    k4 = ch.chamfer_grad1_vpu(x, y, k1[1], k1[3], g1, g2)
    rel = float((k4 - k3).abs().max() / k3.abs().max().clamp_min(1e-20))
    _check("K4 (VPU algebra) vs K3 (<=5e-6 rel)", rel <= 5e-6, f"max rel={rel:.3g}")
    return x, y, k1


def _sparse_checks(dev, rng):
    from geometric_adv_tpu_torch.attack import core as attack_core
    from geometric_adv_tpu_torch.models import sparse_encode
    from geometric_adv_tpu_torch.train.config import Configuration
    from geometric_adv_tpu_torch.train.trainer import AETrainer

    conf = Configuration(
        n_input=[256, 3], bneck_size=128, batch_size=8, learning_rate=0.01,
        dist_weight_list=[1.0], num_iterations=25, num_iterations_thresh=5,
        saver_step=None,
    )
    small = Configuration(n_input=[64, 3], bneck_size=16, encoder_filters=[16, 32, 16],
                          decoder_sizes=[16, 16], saver_step=None)
    tiny = AETrainer(small, dev).model
    with torch.no_grad():  # BN scales away from 1, as the JAX test's
        for name, buf in tiny.named_buffers():
            buf.add_(0.3 * buf.abs() + 0.01)
    xs = torch.from_numpy(rng.randn(5, 64, 3).astype(np.float32)).to(dev)
    res = sparse_vs_dense(tiny, xs)
    _check("sparse encoder gradient == dense at the JAX test's victim "
           "(elementwise rtol 2e-5, atol 1e-7)",
           res["z_equal"] and res["elementwise"] and res["backward_calls"] == 1,
           f"max abs diff={res['max_abs']:.3g}, mask flips={res['flips']}")
    trainer = AETrainer(conf, dev)
    model = trainer.model
    xe = torch.from_numpy(rng.rand(8, 256, 3).astype(np.float32) - 0.5).to(dev)
    res = sparse_vs_dense(model, xe)
    _check("sparse encoder forward bit-identical at the full width", res["z_equal"])
    _check(f"sparse encoder gradient == dense at the full width ({SPARSE_SCALED:g} "
           "of the largest entry)",
           res["max_rel"] <= SPARSE_SCALED and res["backward_calls"] == 1,
           f"max abs diff={res['max_abs']:.3g}, relative {res['max_rel']:.3g}, "
           f"elementwise {res['elementwise']}, mask flips={res['flips']}")
    t = torch.zeros(4, 2048, 128, device=dev)
    t[:, 700] = 1.0
    t[:, 5] = 1.0
    t[:, 1999] = 1.0
    _check("argmax takes the first of tied maxima on the card",
           bool((t.argmax(dim=-2) == 5).all()))

    def trajectories(victim, victim_conf, pairs):
        """25-iteration attacks, sparse and dense, and dense from sources
        one ulp up; -> their metrics."""
        n = victim_conf.n_input[0]
        rng2 = np.random.RandomState(77)
        xs = rng2.rand(pairs, n, 3).astype(np.float32) - 0.5
        gts = rng2.rand(pairs, n, 3).astype(np.float32) - 0.5
        with torch.no_grad():
            tz = victim.encode(torch.from_numpy(gts).to(dev)).float().cpu().numpy()
        outs = {}
        for name, vjp, src in (("sparse", "sparse", xs), ("dense", "dense", xs),
                               ("nudged", "dense", np.nextafter(xs, np.float32(1)))):
            runner = attack_core.AttackRunner(victim, victim_conf, dev,
                                              chamfer_impl="composed", encoder_vjp=vjp)
            outs[name] = runner.attack(src, tz, gts, np.ones(pairs, np.float32)).metrics
        return outs

    attack = dict(dist_weight_list=[1.0], num_iterations=25, num_iterations_thresh=1,
                  learning_rate=0.01)
    outs = trajectories(tiny, Configuration.from_dict({**small.to_dict(), **attack}), 4)
    excess = float(np.max(np.abs(outs["sparse"] - outs["dense"])
                          - (1e-6 + 2e-4 * np.abs(outs["dense"]))))
    _check("attack trajectory sparse vs dense encoder VJP at the JAX test's victim "
           "(rtol 2e-4, atol 1e-6)",
           bool(np.isfinite(outs["sparse"]).all()) and excess <= 0,
           f"max excess over the bar={excess:.3g}")
    # at the full width Adam carries float32 noise into the steps within a
    # few iterations: the sparse run drifts from the dense one about as far
    # as a dense run from sources one ulp away does
    outs = trajectories(model, conf, 8)
    drift = float(np.abs(outs["sparse"] - outs["dense"]).max())
    control = float(np.abs(outs["nudged"] - outs["dense"]).max())
    _check("attack trajectory sparse vs dense at the full width: drift <= 10x "
           "that of sources one ulp up (+1e-5)",
           bool(np.isfinite(outs["sparse"]).all()) and drift <= 10 * control + 1e-5,
           f"sparse drift={drift:.3g}, one-ulp drift={control:.3g}")
    auto = attack_core.AttackRunner(model, conf, dev, chamfer_impl="composed")
    _check("auto routing takes the dense encoder VJP on the card",
           auto.encoder_vjp == "dense")

    attack_core._CHAMFER_CALIB_CACHE.clear()
    runner7 = attack_core.AttackRunner(model, conf, dev)
    decision = next(iter(attack_core._CHAMFER_CALIB_CACHE.values()), None)
    _check("AttackRunner chamfer-impl calibration ran and routed",
           len(attack_core._CHAMFER_CALIB_CACHE) == 1
           and runner7.chamfer_method == ("fused" if decision else "composed"),
           f"decision={'fused' if decision else 'composed'}, "
           f"bound={runner7.chamfer_method}")
    method7 = runner7.chamfer_method
    conf512 = Configuration.from_dict({**conf.to_dict(), "n_input": [512, 3]})
    runner7b = attack_core.AttackRunner(model, conf512, dev)
    key_b = next((k for k in attack_core._CHAMFER_CALIB_CACHE if k[1] == 512), None)
    decision_b = attack_core._CHAMFER_CALIB_CACHE.get(key_b)
    _check("second runner (512 pts) calibrated independently, first unchanged",
           len(attack_core._CHAMFER_CALIB_CACHE) == 2
           and runner7.chamfer_method == method7
           and runner7b.chamfer_method == ("fused" if decision_b else "composed"),
           f"512-pt decision={'fused' if decision_b else 'composed'}")


def _emd_and_frozen_checks(dev, rng, x, y):
    from geometric_adv_tpu_torch.attack.core import _frozen_chamfer_terms
    from geometric_adv_tpu_torch.ops import chamfer as ch
    from geometric_adv_tpu_torch.ops import emd

    xe1 = torch.from_numpy(rng.rand(4, 512, 3).astype(np.float32) - 0.5).to(dev)
    xe2 = torch.from_numpy(rng.rand(4, 448, 3).astype(np.float32) - 0.5).to(dev)

    vf, gf = value_grad_at(xe1, lambda p: emd.emd_loss_fused(p, xe2))
    vc, gc = value_grad_at(xe1, lambda p: emd.match_cost(p, xe2, emd.approx_match(p, xe2)))
    vf, vc = float(vf.sum()), float(vc.sum())
    _check("EMD fused sweep == composed approx_match+match_cost (value, 1e-4)",
           abs(vf - vc) / abs(vc) <= 1e-4, f"rel={abs(vf - vc) / abs(vc):.3g}")
    grel = float((gf - gc).abs().max() / gc.abs().max().clamp_min(1e-9))
    _check("EMD fused sweep gradient == composed (rel 5e-4)", grel <= 5e-4,
           f"max rel={grel:.3g}")

    _check("EMD routing admits K6 at 512x448", emd.sweep_route(512, 448) == "block")
    cost_k, g1_k, _ = emd.emd_sweep(xe1, xe2, True, False)
    cost_p, g1_p, _ = emd.emd_sweep_plain(xe1, xe2, True, False)
    vrel = float(((cost_k - cost_p).abs() / cost_p.abs()).max())
    grel = float((g1_k - g1_p).abs().max() / g1_p.abs().max().clamp_min(1e-9))
    _check("K6 == plain sweep on the card (value 1e-5, grad 1e-4)",
           vrel <= 1e-5 and grel <= 1e-4, f"value rel={vrel:.3g}, grad rel={grel:.3g}")

    m = y.shape[-2]
    pk = ch.chamfer_frozen_payloads(x, y)
    pp = ch.chamfer_loss_payloads_plain(x, y)
    pp = (pp[0], pp[2], pp[4], pp[5], pp[6])  # d1, d2, nn1, snn1, cnt1
    snn = float((pk[3] - pp[3]).abs().max())
    _check("frozen payloads: K5 == plain version on the card",
           all(torch.equal(pk[i], pp[i]) for i in (0, 1, 2, 4)) and snn <= 1e-5,
           f"max|snn diff|={snn:.3g}")
    payload = {"nn1": pk[2], "r": pk[3] - pk[4][..., None] * x, "cnt": pk[4],
               "d2sum0": pk[1].sum(dim=-1), "x1_0": x}

    def frozen(z):
        d1f, mean_d2 = _frozen_chamfer_terms(z, payload, m)
        return d1f.mean(dim=-1) + mean_d2

    vfz, gfz = value_grad_at(x, frozen)
    vex, gex = value_grad_at(x, lambda z: ch.chamfer_loss_per_pc(z, y, method="composed"))
    v_rel = float(((vfz - vex).abs() / vex.abs()).max())
    g_rel = float((gfz - gex).abs().max() / gex.abs().max().clamp_min(1e-9))
    _check("frozen forms at delta=0 == exact chamfer loss+grad (1e-5)",
           v_rel <= 1e-5 and g_rel <= 1e-5, f"value rel={v_rel:.3g}, grad rel={g_rel:.3g}")


def value_grad_at(x, fn):
    """(per-cloud values, gradient of their sum) of ``fn`` at ``x``."""
    p = x.detach().clone().requires_grad_(True)
    v = fn(p)
    v.sum().backward()
    return v.detach(), p.grad


def _metro_and_matrix_checks(dev):
    from geometric_adv_tpu_torch.ops.pairwise import chamfer_distance_matrix
    from geometric_adv_tpu_torch.transfer.metro import (
        hausdorff_sampled,
        nn_distance_values_chunked,
    )

    mrng = np.random.RandomState(7)
    s1 = torch.from_numpy(mrng.rand(30_000, 3).astype(np.float32) - 0.5).to(dev)
    s2 = torch.from_numpy(mrng.rand(30_000, 3).astype(np.float32) * 1.2 - 0.6).to(dev)
    h_kernel = float(hausdorff_sampled(s1, s2))
    d1, d2 = nn_distance_values_chunked(s1, s2)
    h_ref = float(torch.sqrt(torch.maximum(d1.max(), d2.max())))
    hdev = abs(h_kernel - h_ref) / max(abs(h_ref), 1e-9)
    _check("metro hausdorff_sampled @30k: K2 == chunked plain route (1e-5)",
           np.isfinite(h_kernel) and hdev <= 1e-5,
           f"kernel={h_kernel:.6f}, chunked={h_ref:.6f}, rel={hdev:.3g}")

    ppcs = np.random.RandomState(11).rand(24, 2048, 3).astype(np.float32)
    m_exact = chamfer_distance_matrix(ppcs, dev, pair_block=32)
    m_full = chamfer_distance_matrix(ppcs, dev, pair_block=32, screen_chunks=16,
                                     screen_k=16)
    m_part = chamfer_distance_matrix(ppcs, dev, pair_block=32, screen_chunks=64,
                                     screen_k=8)
    full_dev = float(np.max(np.abs(m_full - m_exact) / np.maximum(np.abs(m_exact), 1e-9)))
    majorizes = bool(np.all(m_part >= m_exact - 1e-6))
    _check("screened matrix @2048: full coverage == exact (1e-5), k=8 majorizes",
           full_dev <= 1e-5 and majorizes,
           f"full-coverage rel={full_dev:.3g}, majorizes={majorizes}")


def main(argv=None) -> int:
    """Run the checks; -> 0 when all passed (``sys.exit``s with 1 off the
    card, as the TPU CLI does)."""
    _FAILURES.clear()
    on_cuda = torch.cuda.is_available()
    _check("backend is CUDA", on_cuda,
           torch.cuda.get_device_name(0) if on_cuda else "no CUDA device")
    if not on_cuda:
        print("not on a CUDA card — the remaining checks are meaningless here")
        sys.exit(1)
    dev = torch.device("cuda")
    # full float32, as the checks' bars assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    x, y, _ = _kernel_checks(dev)
    _sparse_checks(dev, rng)
    _emd_and_frozen_checks(dev, rng, x, y)
    _metro_and_matrix_checks(dev)
    print(f"\n{'ALL CHECKS PASSED' if not _FAILURES else 'FAILURES: ' + ', '.join(_FAILURES)}",
          flush=True)
    return 1 if _FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
