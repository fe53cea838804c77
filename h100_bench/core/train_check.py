"""The training cells' check: the program's steps against the reference's,
from the same weights on the same batches.

Two kinds of step are read:

- The start. Set-up drives the program's trainer through its first three
  steps with its own train call, each on a batch of rows of its own, and
  reads each step's loss, the first step's gradient as Adam holds it after
  that step (``exp_avg / (1 - b1)``) and each weight's change after the
  third. The reference takes the same three steps from the same weights.
- The window's own steps. A ``Tap`` on the program's model and optimizer,
  in every window call, copies the parameters and Adam's state before and
  after a few steps drawn from the seed. The reference takes each of those
  steps from the program's state before it, on the batch that the step
  should have fed, and is compared with the program's state after it: the
  gradient the step fed Adam (from the first moment before and after it)
  and each weight's change. The reference follows the program step by step
  here, since float32 training parts from itself within a few steps; the
  start above checks the state these steps begin from.

The numbers, of which a workload's ``limits`` name those it compares:

- ``loss_gap``: the largest relative gap of a start step's loss;
  ``loss_gap.step1``: the first step's;
- ``grad_gap``: the gap between the program's and the reference's norm of a
  leaf's first gradient, over the larger of the reference's norm of that
  leaf and the median leaf's, at the worst leaf; ``grad_gap.median``: at
  the median leaf;
- ``update_gap``, ``update_gap.median``: the same of a leaf's change after
  the three start steps;
- ``step_grad_gap``, ``step_update_gap``: the same of the gradient and the
  change of a window step, at the worst leaf of the worst sampled step.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a bias before batch norm, whose gradient is nought but for rounding) move
by round-off alone under Adam and are left out of the leaf gaps.
"""

from __future__ import annotations

import math

import torch

from h100_bench.core.harness import Check
from h100_bench.core.precision import pinned
from h100_bench.reference.training import B1, adam_steps


class Readings:
    """What the program's first three steps leave: losses, first-gradient
    norms and change norms, by leaf name."""

    def __init__(self):
        self.losses = []
        self.grad_norms = {}
        self.change_norms = {}

    def after_step(self, model, optimizer, loss: float):
        self.losses.append(float(loss))
        if len(self.losses) == 1:
            for name, p in model.named_parameters():
                held = optimizer.state.get(p, {}).get("exp_avg")  # none: no step taken
                self.grad_norms[name] = 0.0 if held is None else float((held / (1 - B1)).norm())

    def after_three(self, model, start: dict):
        for name, p in model.named_parameters():
            self.change_norms[name] = float((p.detach() - start[name]).norm())


def adam_state(model, optimizer) -> dict:
    """Copies of the parameters, Adam's moments and its step count:
    {"weights": {name: w}, "moments": {name: (first, second)}, "taken": n}."""
    weights, moments, taken = {}, {}, 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            held = optimizer.state.get(p, {})
            weights[name] = p.detach().clone()
            if "exp_avg" in held:
                moments[name] = (held["exp_avg"].clone(), held["exp_avg_sq"].clone())
                taken = int(held["step"])
            else:  # no step taken
                moments[name] = (torch.zeros_like(p), torch.zeros_like(p))
    return {"weights": weights, "moments": moments, "taken": taken}


class Tap:
    """Hooks on the program's model and optimizer for one window call. Of
    every training step: the rows fed (the first coordinate of each cloud,
    which tells the clouds apart) and, once the optimizer has stepped, their
    number; at the steps ``sample`` (0-based within the call), the
    ``adam_state`` before and after the step."""

    def __init__(self, model, optimizer, sample):
        self.model, self.optimizer = model, optimizer
        self.sample = {int(k) for k in sample}
        self.fed, self.pending, self.rows, self.steps = [], 0, 0, 0
        self.taken = {}
        self.handles = [model.register_forward_pre_hook(self._forward),
                        optimizer.register_step_pre_hook(self._before),
                        optimizer.register_step_post_hook(self._after)]

    def close(self):
        for h in self.handles:
            h.remove()

    def _forward(self, module, args):
        if module.training:
            x = args[0]
            self.fed.append(x[:, 0, 0].detach().clone())
            self.pending = len(x)

    def _before(self, _optimizer, _args, _kwargs):
        if self.steps in self.sample:
            self.taken[self.steps] = {"before": adam_state(self.model, self.optimizer)}

    def _after(self, _optimizer, _args, _kwargs):
        if self.steps in self.taken:
            self.taken[self.steps]["after"] = adam_state(self.model, self.optimizer)
        self.rows += self.pending
        self.pending = 0
        self.steps += 1


def _variant(kind: str, batches: list, loss_fn, s):
    """(batches, loss function, TF32 on) of the reference put in the
    program's place: "tf32", with TF32 on (the control); "half_batch", each
    step on the first half of its batch; "altered", every reconstruction
    scaled by 1.01 where it is made (two planted faults)."""
    fn = loss_fn(s)
    if kind == "half_batch":
        batches = [(b[0][:len(b[0]) // 2],) + tuple(b[1:]) for b in batches]
    elif kind == "altered":
        fn = loss_fn(s, alter=lambda r: r * 1.01)
    elif kind != "tf32":
        raise ValueError(f"no stand-in {kind!r}")
    return batches, fn, kind == "tf32"


def stand_in(kind: str, s, loss_fn) -> "Readings":
    """Readings of the start's three steps with the reference in the
    program's place (``_variant``)."""
    names = [k for k, _ in s.trainer.model.named_parameters()]
    batches, fn, tf32 = _variant(kind, s.batches, loss_fn, s)
    with pinned(tf32):
        losses, first, after, _ = adam_steps(s.w, names, batches, fn,
                                             s.cell.config["learning_rate"])
    r = Readings()
    r.losses = list(losses)
    r.grad_norms = {k: float(g.norm()) for k, g in first.items()}
    r.change_norms = {k: float((after[k] - s.w[k]).norm()) for k in after}
    return r


def stand_in_step(kind: str, s, loss_fn, batch: tuple, before: dict) -> dict:
    """The state after one window step taken by the reference in the
    program's place (``_variant``) from the program's state ``before``."""
    batches, fn, tf32 = _variant(kind, [batch], loss_fn, s)
    w = dict(s.w, **before["weights"])
    with pinned(tf32):
        _, _, after, moments = adam_steps(w, list(before["weights"]), batches, fn,
                                          s.cell.config["learning_rate"],
                                          before["moments"], before["taken"])
    return {"weights": after, "moments": moments, "taken": before["taken"] + 1}


def _kept(grad_ref: dict) -> list:
    median = float(torch.tensor(list(grad_ref.values())).median())
    return [k for k in grad_ref if grad_ref[k] >= 1e-3 * median]


def _leaf_gaps(got: dict, want: dict, names: list) -> dict:
    floor = float(torch.tensor([want[k] for k in names]).median())
    return {k: abs(got[k] - want[k]) / max(want[k], floor) for k in names}


def _worst(gaps: list) -> float:
    """The largest gap; nan where there is none or one is nan."""
    return math.nan if not gaps or any(math.isnan(g) for g in gaps) else max(gaps)


def step_gaps(steps: list, start: dict, loss_fn, lr: float) -> dict:
    """``step_grad_gap`` and ``step_update_gap`` of the window steps
    ``steps`` ([(batch, {"before": state, "after": state})]; a step with no
    state after it reads nan), the reference at float32 taking each from
    the program's state before it; ``start`` gives the leaves the program
    does not train."""
    grad_gap, change_gap = [], []
    with pinned(False):
        for batch, taken in steps:
            if "after" not in taken:
                grad_gap.append(math.nan)
                change_gap.append(math.nan)
                continue
            before, after = taken["before"], taken["after"]
            names = list(before["weights"])
            _, g_ref, w_ref, _ = adam_steps(dict(start, **before["weights"]), names, [batch],
                                            loss_fn, lr, before["moments"], before["taken"])
            m0 = {k: before["moments"][k][0] for k in names}
            g_got = {k: float((m0[k] + (after["moments"][k][0] - m0[k]) / (1 - B1)).norm())
                     for k in names}
            grad_ref = {k: float(g_ref[k].norm()) for k in names}
            kept = _kept(grad_ref)
            w0 = before["weights"]
            change_ref = {k: float((w_ref[k] - w0[k]).norm()) for k in names}
            change_got = {k: float((after["weights"][k] - w0[k]).norm()) for k in names}
            grad_gap.append(max(_leaf_gaps(g_got, grad_ref, kept).values()))
            change_gap.append(max(_leaf_gaps(change_got, change_ref, kept).values()))
    return {"step_grad_gap": _worst(grad_gap), "step_update_gap": _worst(change_gap),
            "step gaps (gradient, change) by sampled step": list(zip(grad_gap, change_gap))}


def compare(readings: Readings, start_steps: tuple, start: dict, window: dict,
            limits: dict, info: dict) -> list:
    """The checks that ``limits`` names. ``start_steps`` is the reference's
    (losses, first gradients, weights after three steps) of the start,
    ``start`` the weights both began at, ``window`` the window's numbers
    (``step_gaps`` and the entry's own). Every candidate is printed in
    ``info``: ``loss_gap`` (the worst step), ``loss_gap.step1``,
    ``grad_gap`` and ``update_gap`` (the worst leaf), ``grad_gap.median``
    and ``update_gap.median`` (the median leaf), and the window's."""
    losses, first_grads, after = start_steps
    grad_ref = {k: float(g.norm()) for k, g in first_grads.items()}
    change_ref = {k: float((after[k] - start[k]).norm()) for k in after}
    kept = _kept(grad_ref)
    out = [k for k in grad_ref if k not in kept]
    info["leaves left out (gradient nought)"] = f"{len(out)}: {', '.join(out[:8])}" + (
        ", ..." if len(out) > 8 else "")
    steps = [abs(a - b) / abs(b) for a, b in zip(readings.losses, losses)]
    grad = _leaf_gaps(readings.grad_norms, grad_ref, kept)
    change = _leaf_gaps(readings.change_norms, change_ref, kept)
    numbers = {
        "loss_gap": max(steps), "loss_gap.step1": steps[0],
        "grad_gap": max(grad.values()), "update_gap": max(change.values()),
        "grad_gap.median": float(torch.tensor(list(grad.values())).median()),
        "update_gap.median": float(torch.tensor(list(change.values())).median()),
    }
    numbers.update({k: v for k, v in window.items() if not isinstance(v, list)})
    info["losses program / reference"] = f"{readings.losses} / {list(losses)}"
    info["loss gaps by step"] = steps
    info["worst leaves (gradient, change)"] = (f"{max(grad, key=grad.get)}, "
                                               f"{max(change, key=change.get)}")
    info.update({k: v for k, v in window.items() if isinstance(v, list)})
    info["candidates"] = numbers
    return [Check(name, numbers[name], limit) for name, limit in limits.items()]
