"""The attack as ``run_attack`` runs it: ``AttackRunner.attack`` on calls of
the traffic's pairs, the victim frozen in inference mode.

Set-up builds the victim (``PointNetAE``) with the benchmark's seeded
weights, its batch-norm statistics taken from the reference's batch
statistics on seeded clouds, makes the pair pool, gives the runner the
targets' codes and reconstruction errors from the victim (what
``run_attack`` reads from the ``tst_ae`` stage), and warms every shape up
with one call of the window's pairs at two iterations. A window call attacks
the pool's next ``pairs_per_call`` pairs with the configuration's
iterations.

What the check reads, for a sample of each window call's pairs drawn from
the seed: the call's outputs (the kept metrics, adversarial clouds and
reconstructions), and the adversarial clouds the call's iterations fed the
victim at the ``follow_iterations`` and at every iteration from the
threshold on, taken by a forward pre-hook on the victim's encoder (an
indexed copy of a few rows; the traced call takes none). Compared:

- ``recon_gap``: the reference's reconstruction of each kept adversarial
  cloud against the program's (largest entry gap over the largest entry):
  the victim's forward in inference mode;
- ``metric_gap``: the five metrics the reference computes from the kept
  clouds (its own reconstructions, chamfers and T-RE base) against the
  program's, relatively: both chamfers;
- ``step_gap``: the reference's own attack of the pair from the same start
  against the program's iterate at each of the ``follow_iterations`` (the
  largest point gap over the largest point's perturbation): the chamfers'
  and the victim's gradients and the Adam step. The attack is chaotic in
  float32, so only early iterates can be followed;
- ``track_gap``: the program's kept T-RE against the least T-RE the
  reference finds among the program's own iterates from the threshold on:
  the best-so-far tracking.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.core.clouds import generator, make_clouds, make_pairs
from h100_bench.core.harness import Check
from h100_bench.core.precision import pinned
from h100_bench.core.weights import layout, seeded_weights
from h100_bench.reference import attack as ref_attack
from h100_bench.reference import pointnet_ae as ref_ae
from h100_bench.reference.chamfer import chamfer_per_pc

UNIT = "pair-iters"


class State:
    pass


class Capture:
    """Forward pre-hook: at the iterations ``keep`` of a call, a copy of
    the ``rows`` of the victim's input."""

    def __init__(self, rows: torch.Tensor, keep: set):
        self.rows, self.keep = rows, keep
        self.t = 0
        self.saved = {}

    def __call__(self, _module, args):
        if self.t in self.keep:
            with torch.no_grad():
                self.saved[self.t] = args[0].detach().index_select(0, self.rows)
        self.t += 1


def victim_weights(model, cfg, tr, gen, device):
    """Seeded weights with the encoder's statistics set from the reference's
    batch statistics on seeded clouds, so that inference mode normalises."""
    w = seeded_weights(layout(model), gen, device)
    calib, _ = make_clouds(gen, tr["bn_calibration_clouds"], cfg["n_points"], device)
    for i, (mean, var) in enumerate(ref_ae.batch_statistics(w, calib)):
        w[f"encoder.bn_{i}.running_mean"] = mean
        w[f"encoder.bn_{i}.running_var"] = var
    return w


def setup(cell):
    from geometric_adv_tpu_torch.attack.core import AttackRunner
    from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE
    from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
    from geometric_adv_tpu_torch.train.config import Configuration

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    n, att = cfg["n_points"], cfg["attack"]
    if len(att["dist_weight_list"]) != 1:
        raise ValueError("the check follows one distance weight")
    s = State()
    s.cell = cell
    gen = generator(cell.seed, dev)
    model = PointNetAE(n_points=n, bneck_size=cfg["bneck_size"],
                       encoder_filters=cfg["encoder_filters"],
                       decoder_sizes=cfg["decoder_sizes"],
                       bn_momentum=cfg["b_norm_decay"]).to(dev)
    s.w = victim_weights(model, cfg, tr, gen, dev)
    model.load_state_dict(s.w)
    model.eval()
    s.per_call = tr["pairs_per_call"]
    s.src, s.tgt = make_pairs(gen, s.per_call * tr["calls_in_pool"], n, dev)
    with torch.no_grad():
        z = torch.cat([model.encode(c) for c in s.tgt.split(s.per_call)])
        ref = torch.cat([chamfer_loss_per_pc(model.decode(c), t)
                         for c, t in zip(z.split(s.per_call), s.tgt.split(s.per_call))])
    s.host = [a.cpu().numpy() for a in (s.src, z, s.tgt, ref)]
    conf = Configuration(n_input=[n, 3], loss="chamfer", bneck_size=cfg["bneck_size"],
                         encoder_filters=cfg["encoder_filters"],
                         decoder_sizes=cfg["decoder_sizes"])
    conf.learning_rate = att["learning_rate"]
    conf.dist_weight_list = att["dist_weight_list"]
    conf.loss_adv_type, conf.loss_dist_type = att["loss_adv_type"], att["loss_dist_type"]
    s.conf = conf
    s.runner = AttackRunner(model, conf, dev, chamfer_impl=tr["chamfer_impl"],
                            batch_size=s.per_call)
    s.model = model
    cell.info["route"] = s.runner.attack_mode
    # warm-up: the window's shapes, two iterations, tracking from the first
    conf.num_iterations, conf.num_iterations_thresh = 2, 1
    _attack(s, 0)
    conf.num_iterations = att["num_iterations"]
    conf.num_iterations_thresh = att["num_iterations_thresh"]
    s.follow = sorted(tr["follow_iterations"])
    s.late = list(range(conf.num_iterations_thresh, conf.num_iterations + 1))
    s.calls = 0
    s.kept = []  # per window call: (pool rows, outputs, followed, late iterates)
    s.rng = np.random.default_rng([cell.seed % (1 << 63), 7])
    return s


def _attack(s, k):
    sl = slice(k * s.per_call, (k + 1) * s.per_call)
    return s.runner.attack(*(a[sl] for a in s.host), batch_size=s.per_call)


def call(s) -> float:
    k = s.calls % s.cell.traffic["calls_in_pool"]
    rows = np.sort(s.rng.choice(s.per_call, s.cell.traffic["check_pairs_per_call"],
                                replace=False))
    cap = Capture(torch.as_tensor(rows, device=s.cell.device), set(s.follow + s.late))
    handle = s.model.encoder.register_forward_pre_hook(cap)
    try:
        out = _attack(s, k)
    finally:
        handle.remove()
    s.kept.append((k * s.per_call + rows,
                   [a[0, rows] for a in out],
                   {t: cap.saved[t].cpu() for t in s.follow},
                   torch.stack([cap.saved[t] for t in s.late], dim=1).cpu()))
    s.calls += 1
    return _units(s)


def traced_call(s) -> float:
    """A call under the profiler: nothing captured, nothing kept."""
    _attack(s, s.calls % s.cell.traffic["calls_in_pool"])
    return _units(s)


def _units(s) -> float:
    return float(s.per_call * s.conf.num_iterations * len(s.conf.dist_weight_list))


def trace_module(s):
    return s.model.encoder


def shapes(s) -> dict:
    n = s.cell.config["n_points"]
    return {"chamfer": [s.per_call * len(s.conf.dist_weight_list), n, n],
            "units_per_step": _units(s) / s.conf.num_iterations}


def _rel(a, b):
    return (a - b).abs() / b.abs()


def _free_program(s):
    for name in ("runner", "model"):
        if hasattr(s, name):
            delattr(s, name)
    if s.cell.device.type == "cuda":
        torch.cuda.empty_cache()


def judge(s, idx, outputs, followed, late) -> list:
    """The four checks of the pool's pairs ``idx``: ``outputs`` (kept
    metrics [K, 5], adversarial clouds and reconstructions [K, n, 3]),
    ``followed`` ({t: the iterate [K, n, 3]}) and ``late`` (the iterates from
    the threshold on, [K, L, n, 3]); the reference in float32, TF32 off."""
    with pinned(False):
        return _judge(s, idx, outputs, followed, late)


def _judge(s, idx, outputs, followed, late) -> list:
    cfg, dev = s.cell.config, s.cell.device
    n, att, limits = cfg["n_points"], cfg["attack"], s.cell.workload["limits"]
    got_m, got_adv, got_recon = (torch.as_tensor(np.asarray(a), device=dev) for a in outputs)
    src, tgt = s.src[idx], s.tgt[idx]
    ref = ref_attack.target_reference_error(s.w, tgt, n)
    want_m, want_recon = ref_attack.metrics(s.w, got_adv, src, tgt, ref, n)
    numbers = {
        "recon_gap": float(((got_recon - want_recon).abs().amax(dim=(1, 2))
                            / want_recon.abs().amax(dim=(1, 2))).max()),
        "metric_gap": float(_rel(got_m, want_m).max()),
    }
    pert0 = ref_attack.init_pert((s.per_call, n, 3)).to(dev)[idx % s.per_call]
    _, _, seen = ref_attack.attack(s.w, src, tgt, ref, pert0, n, max(s.follow),
                                   att["num_iterations_thresh"], att["learning_rate"],
                                   float(att["dist_weight_list"][0]), record=set(s.follow))
    steps = {}
    for t in s.follow:
        moved = (seen[t] - src).norm(dim=-1).amax(dim=-1)
        gap = (followed[t].to(dev) - seen[t]).norm(dim=-1).amax(dim=-1)
        steps[t] = float((gap / moved).max())
    numbers["step_gap"] = max(steps.values())
    with torch.no_grad():
        least = []
        for k in range(len(idx)):
            it = late[k].to(dev)
            recon = ref_attack.reconstruct(s.w, it, n)
            least.append(chamfer_per_pc(recon, tgt[k:k + 1].expand(len(it), -1, -1)).min())
        least = torch.stack(least)
    numbers["track_gap"] = float(_rel(got_m[:, 4], least).max())
    s.cell.info["step_gap by iteration"] = steps
    s.cell.info["candidates"] = numbers
    return [Check(name, numbers[name], limit) for name, limit in limits.items()]


def check(s) -> list:
    _free_program(s)
    idx = torch.as_tensor(np.concatenate([k[0] for k in s.kept]), device=s.cell.device)
    outputs = [np.concatenate([k[1][j] for k in s.kept]) for j in range(3)]
    followed = {t: torch.cat([k[2][t] for k in s.kept]) for t in s.follow}
    late = torch.cat([k[3] for k in s.kept])
    return judge(s, idx, outputs, followed, late)


def control(s, kind: str, calls: int = 3) -> list:
    """The checks of the reference put in the program's place for the pairs
    ``calls`` window calls would sample: "tf32", the reference with TF32 on."""
    if kind != "tf32":
        raise ValueError(f"no {kind!r} control for the attack")
    _free_program(s)
    cfg, n, dev = s.cell.config, s.cell.config["n_points"], s.cell.device
    att = cfg["attack"]
    rows = [k * s.per_call + np.sort(s.rng.choice(
        s.per_call, s.cell.traffic["check_pairs_per_call"], replace=False))
        for k in range(calls)]
    idx = torch.as_tensor(np.concatenate(rows), device=dev)
    src, tgt = s.src[idx], s.tgt[idx]
    with pinned(True):
        ref = ref_attack.target_reference_error(s.w, tgt, n)
        pert0 = ref_attack.init_pert((s.per_call, n, 3)).to(dev)[idx % s.per_call]
        got_m, got_adv, seen = ref_attack.attack(
            s.w, src, tgt, ref, pert0, n, att["num_iterations"],
            att["num_iterations_thresh"], att["learning_rate"],
            float(att["dist_weight_list"][0]), record=set(s.follow + s.late))
        got_recon = ref_attack.reconstruct(s.w, got_adv, n).detach()
    late = torch.stack([seen[t] for t in s.late], dim=1)
    return judge(s, idx, [a.cpu().numpy() for a in (got_m, got_adv, got_recon)],
                 {t: seen[t] for t in s.follow}, late)
