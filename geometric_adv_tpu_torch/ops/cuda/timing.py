"""Timers for the hand-written kernels, and a command that times K3-K7 and
the pruned chamfer op alone and keeps their outputs.

``sync_timed`` and ``device_timed`` serve ``chip_smoke.py`` too. The
command, on one card:

    python3 -m geometric_adv_tpu_torch.ops.cuda.timing --label NAME [--out DIR]
    python3 -m geometric_adv_tpu_torch.ops.cuda.timing --compare A.pt B.pt

times, on inputs from fixed numpy seeds (uniform clouds in [-0.5, 0.5)^3):

- K3 ``chamfer_grad1_cuda`` and K4 ``chamfer_grad1_vpu_cuda`` at
  [24, 64, 250] x 2048^2, with K1's argmins and uniform weights, 50 calls;
- K5 ``chamfer_loss_payloads_cuda`` at [64] x 2048^2 and [50] x 1024^2,
  50 calls;
- K6 ``emd_sweep_block_cuda`` at [24, 50] x 1024^2 and K7
  ``emd_sweep_tiled_cuda`` at [24, 50] x 1024^2 and 2048^2, in g1 mode (the
  EMD attack's call), 10 calls;
- the pruned chamfer (``ops/chamfer_hier.py``, K8) through its public
  contracts, ``nn_distance_hier(x, y)`` and ``nn_direction_sorted(x, y)``,
  at [64] x 2048^2 on the synthetic dataset's surface clouds (sphere, cube,
  torus, cone) and on uniform clouds, 20 calls, with the device time of
  each of the port's kernels it launches (``kernels_ms``, by name) and its
  kernel launches per call (``launches``).

Each time is given twice, per call after a warm-up: ``ms`` from CUDA events
around the calls, which counts the wrapper's host time where that is longer
than the kernel's (K3's, K4's), and ``device_ms``, the kernels' own time in a
torch.profiler trace of the same calls. Each result is one JSON line on
standard output; the outputs go to ``DIR/NAME.pt`` (default
``build/kernel_times`` in the checkout), and ``--compare`` says whether two
such files hold the same bits. The module calls only the wrappers' public
contracts, so a copy of it in an older checkout of the package times that
checkout's kernels on the same inputs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N = 2048
K3_BATCHES = (24, 64, 250)
K5_SHAPES = ((64, N), (50, 1024))
EMD_BATCHES = (24, 50)
# (kernel, points): K6 at 1024, K7 at 1024 (the same function as K6) and 2048
EMD_SWEEPS = (("K6", 1024), ("K7", 1024), ("K7", N))
HIER_BATCH = 64
SHAPES = ("sphere", "cube", "torus", "cone")


def sync_timed(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn, reps: int):
    """The CUDA entries of a torch.profiler trace of ``reps`` calls after one
    warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # a span of the program (``utils/profiling.py``) shows on the device too,
    # as a user annotation over its kernels: no device operation of its own
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_timed(fn, reps: int) -> float:
    """Mean milliseconds per call of the device's kernels, from a
    torch.profiler trace of ``reps`` calls after one warm-up: a kernel
    shorter than its wrapper's host time (K3) is timed so."""
    return sum(e.self_device_time_total for e in _device_events(fn, reps)) / 1e3 / reps


def device_kernels(fn, reps: int) -> tuple[dict, float]:
    """({kernel name: mean device ms per call}, kernel launches per call)
    from a torch.profiler trace of ``reps`` calls after one warm-up."""
    kernels = [e for e in _device_events(fn, reps)
               if not e.key.startswith(("Memcpy", "Memset"))]
    return ({e.key: e.self_device_time_total / 1e3 / reps for e in kernels},
            sum(e.count for e in kernels) / reps)


def _surface(b, n, seed):
    from geometric_adv_tpu_torch.data.synthetic import sample_shape

    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(np.stack([
        sample_shape(SHAPES[i % len(SHAPES)], n, rng) for i in range(b)
    ]).astype(np.float32)).cuda() for _ in range(2))


def _clouds(b, n, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.rand(b, n, 3).astype(np.float32) - 0.5).cuda()
                 for _ in range(2))


def _emit(**record):
    print(json.dumps(record), flush=True)


def time_kernels(label: str) -> dict:
    """Time K3-K7 (one JSON line each); returns their outputs."""
    from geometric_adv_tpu_torch.ops import emd
    from geometric_adv_tpu_torch.ops.cuda import chamfer as cu
    from geometric_adv_tpu_torch.ops.cuda import emd as cu_emd

    def emit_times(fn, reps, **keys):
        _emit(label=label, **keys, ms=sync_timed(fn, reps), device_ms=device_timed(fn, reps))

    outputs = {}
    for b in K3_BATCHES:
        x1, x2 = _clouds(b, N, seed=b)
        _, i1, _, i2 = cu.nn_distance_cuda(x1, x2)
        rng = np.random.RandomState(b + 1)
        g1, g2 = (torch.from_numpy(rng.rand(b, N).astype(np.float32)).cuda()
                  for _ in range(2))
        args = (x1, x2, i1, i2, g1, g2)
        for name, fn in (("K3", cu.chamfer_grad1_cuda), ("K4", cu.chamfer_grad1_vpu_cuda)):
            outputs[f"{name} [{b}]"] = [fn(*args).cpu()]
            emit_times(lambda: fn(*args), 50, kernel=name, b=b)
    for b, n in K5_SHAPES:
        x1, x2 = _clouds(b, n, seed=200 + b)
        outputs[f"K5 [{b}, {n}]"] = [t.cpu() for t in cu.chamfer_loss_payloads_cuda(x1, x2)]
        emit_times(lambda: cu.chamfer_loss_payloads_cuda(x1, x2), 50, kernel="K5", b=b, n=n)
    sweeps = {"K6": cu_emd.emd_sweep_block_cuda, "K7": cu_emd.emd_sweep_tiled_cuda}
    for name, n in EMD_SWEEPS:
        for b in EMD_BATCHES:
            x, y = _clouds(b, n, seed=100 + b + (n != N))
            fn = sweeps[name]
            cost, g1, _ = fn(x, y, emd._LEVELS, True, False)
            outputs[f"{name} [{b}]" + ("" if n == N else f" x {n}")] = [cost.cpu(), g1.cpu()]
            emit_times(lambda: fn(x, y, emd._LEVELS, True, False), 10, kernel=name, b=b, n=n)
    return outputs


def time_hier(label: str) -> dict:
    """Time the pruned chamfer's public contracts (one JSON line each);
    returns their outputs."""
    from geometric_adv_tpu_torch.ops import chamfer_hier as hier

    outputs = {}
    for kind, (x, y) in (("surface", _surface(HIER_BATCH, N, seed=3)),
                         ("uniform", _clouds(HIER_BATCH, N, seed=4))):
        calls = {"nn_distance_hier": lambda: hier.nn_distance_hier(x, y),
                 "nn_direction_sorted": lambda: hier.nn_direction_sorted(x, y)}
        for name, fn in calls.items():
            outputs[f"{name} {kind} [{HIER_BATCH}]"] = [t.cpu() for t in fn()]
            kernels, launches = device_kernels(fn, 20)
            _emit(label=label, op=name, clouds=kind, b=HIER_BATCH, n=N, ms=sync_timed(fn, 20),
                  device_ms=sum(kernels.values()), launches=launches,
                  kernels_ms={k: v for k, v in kernels.items() if "hier" in k})
    return outputs


def compare(a: Path, b: Path) -> bool:
    """One JSON line per output of two saved runs; True if all bit-equal."""
    x, y = torch.load(a), torch.load(b)
    same = True
    for key in x:
        pairs = list(zip(x[key], y[key]))
        equal = all(torch.equal(u, v) for u, v in pairs)
        same = same and equal
        _emit(compare=[str(a), str(b)], output=key, bit_equal=equal,
              max_abs_diff=max(float((u.double() - v.double()).abs().max()) for u, v in pairs))
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", help="name of this run")
    ap.add_argument("--out", type=Path,
                    default=Path(__file__).resolve().parents[3] / "build" / "kernel_times")
    ap.add_argument("--compare", nargs=2, type=Path, metavar="FILE.pt")
    args = ap.parse_args()
    if args.compare:
        return 0 if compare(*args.compare) else 1
    if not args.label:
        ap.error("--label is required")
    if not torch.cuda.is_available():
        print("timing: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    _emit(label=args.label, card=card)
    outputs = time_kernels(args.label)
    outputs.update(time_hier(args.label))
    args.out.mkdir(parents=True, exist_ok=True)
    torch.save(outputs, args.out / f"{args.label}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
