"""A module body's train-mode step as two CUDA graphs: ``BodyGraphs``.

A module that owns a ``BodyGraphs`` calls ``graphs.call(module, body, x)``
from its ``forward`` where its route applies (``models/layers.py``:
``PointMLP``, the victim's encoder, and ``FCStack``, its decoder). ``body``
is the module's own eager forward. The first two times a capture key is
seen, ``body(x)`` runs through autograd as it always did, and warms the key
up. The third time, the body's forward and its backward are each captured
once as a CUDA graph, and replayed from then on: one graph launch forward
and one backward, inside an autograd ``Function`` (as
``torch.cuda.make_graphed_callables`` places them), in place of the body's
autograd nodes and their dispatch. The module's own ``__call__`` and hooks
run as before, outside the graphs.

The graphs hold the body's own kernels, launched as the eager step
launches them, on the same shapes and storages, so a replayed step is the
eager step bit for bit. Capturing executes nothing, so it moves no state
(batch norm's running statistics included); the step that captures then
replays the graphs.

The capture key is the input's shape, dtype, device and whether it needs a
gradient; cuBLAS's float32 precision (TF32 or not); the data pointer, shape
and grad flag of every parameter and buffer of the module's layers (its
children, which hold all of them: ``layer_tensors``); and the caller's
``constants`` (what the body's kernels take by value, such as batch norm's
eps and momentum). A change of any of them is a new key:
``load_state_dict``, which copies in place, keeps the key, and ``.to()``,
which moves the storages, makes a new one. Graphs of storages that the
module no longer holds are dropped at the next capture.

What a replay hands out is copied from the graphs' static buffers, so
nothing the next replay overwrites leaves the step: the output by a
device-to-device copy, and the gradients by one concatenation (one kernel),
handed out as views of it (``_copies``). A backward replay
reads the activations of the last forward replay, so a forward replay is
refused, and the body runs eager, while an earlier replay's autograd node
is alive and its backward has not run; a backward run again (with
``retain_graph``) after a later forward replay raises.

The kernel wrappers count their launches in Python
(``ops/cuda/build.py::counted``), which a replay does not run: the
launches counted while capturing are taken back (a capture launches
nothing) and added again at each replay. A ``BodyGraphs(counted=True)``
(the encoder's) counts ``train.graph_captures`` and ``train.graph_replays``
(``utils/profiling.py``): one capture per key and one replay per graphed
step.
"""

from __future__ import annotations

import weakref

import torch
from torch._utils import _unflatten_dense_tensors
from torch.autograd.function import once_differentiable

from geometric_adv_tpu_torch.ops.cuda import build
from geometric_adv_tpu_torch.utils.profiling import count

CAPTURE_AT = 3  # the sighting of a key that captures it; the earlier ones warm it up
_MAX_KEYS = 64  # keys seen fewer times than CAPTURE_AT, kept at most


class _Captured:
    """The two graphs of one key and their static buffers: the input
    ``x``, the output ``out``, the output's gradient ``grad_out``, and
    ``grads``, one for ``x`` where it needs one and one
    for each parameter that needs one (``leaves``, their indices);
    ``launches``, each wrapper's launches a forward and a backward
    replay; ``live``, a weak reference to the token of the last forward
    replay, which its autograd node holds; ``replays``, the forward
    replays so far."""

    __slots__ = ("forward", "backward", "x", "out", "grad_out", "grads", "leaves",
                 "launches", "live", "replays")

    def busy(self) -> bool:
        """Whether the last forward replay's backward may still have to
        read its activations."""
        token = None if self.live is None else self.live()
        return token is not None and not token.backward_ran


class _Token:
    """Held by a replay's autograd node, and dies with it: the replay's
    number and whether its backward ran."""

    __slots__ = ("replay", "backward_ran", "__weakref__")

    def __init__(self, replay: int):
        self.replay, self.backward_ran = replay, False


def _launches() -> dict:
    return {fn: fn.launches for fn in build.COUNTED}


def _delta(before: dict, after: dict) -> list:
    return [(fn, n - before.get(fn, 0)) for fn, n in after.items() if n != before.get(fn, 0)]


def _add(launches: list, sign: int = 1) -> None:
    for fn, n in launches:
        fn.launches += sign * n


def _copies(static: list) -> list:
    """Fresh copies of the tensors of ``static`` (None stays None), made by
    one concatenation and handed out as views of it: one kernel and three
    host calls, where a copy each costs a host call each."""
    held = [t for t in static if t is not None]
    copies = iter(_unflatten_dense_tensors(torch.cat([t.view(-1) for t in held]), held))
    return [None if t is None else next(copies) for t in static]


def layer_tensors(module: torch.nn.Module) -> tuple[tuple, tuple]:
    """``module``'s parameters and buffers, in the order of ``parameters()``
    and ``buffers()``, read off its children alone: a body's layers hold
    every tensor it reads, and this walk costs a fraction of
    ``parameters()``'s, which names every module it passes."""
    params, buffers = [], []
    for layer in module.children():
        params += [p for p in layer._parameters.values() if p is not None]
        buffers += [b for b in layer._buffers.values() if b is not None]
    return tuple(params), tuple(buffers)


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, captured, token, x, *params):
        captured.x.copy_(x)
        captured.replays += 1
        captured.forward.replay()
        _add(captured.launches[0])
        ctx.captured, ctx.token = captured, token
        return captured.out.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        captured, token = ctx.captured, ctx.token
        if token.replay != captured.replays:
            raise RuntimeError("a CUDA-graph replay's backward ran again after a later "
                               "forward replay overwrote its activations")
        token.backward_ran = True
        captured.grad_out.copy_(grad_out)
        captured.backward.replay()
        _add(captured.launches[1])
        grads = _copies(captured.grads)
        dx = grads.pop(0) if captured.x.requires_grad else None
        dparams = [None] * (len(ctx.needs_input_grad) - 3)
        for i, g in zip(captured.leaves, grads):
            dparams[i] = g
        return (None, None, dx, *dparams)


def _capture_graph(fn, device: torch.device, pool, stream):
    """(a CUDA graph of ``fn()``, ``fn()``'s result), captured on ``stream``
    into the memory pool ``pool``."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool, stream=stream):
        result = fn()
    return graph, result


class BodyGraphs:
    """The captured graphs of one module's body, by key, and the keys seen
    so far. A copy or a pickle of it (``copy.deepcopy`` of the module) is a
    new, empty one."""

    def __init__(self, counted: bool = False):
        self.counted = counted
        self.seen: dict = {}
        self.graphs: dict = {}

    def __reduce__(self):
        return BodyGraphs, (self.counted,)

    @staticmethod
    def key(params: tuple, buffers: tuple, x: torch.Tensor, constants=()) -> tuple:
        return (x.shape, x.dtype, x.device, x.requires_grad,
                torch.get_float32_matmul_precision(), constants,
                tuple((t.data_ptr(), t.shape, t.requires_grad) for t in params + buffers))

    def call(self, module: torch.nn.Module, body, x: torch.Tensor, constants=()):
        """``body(x)``: eager until the key's ``CAPTURE_AT``-th sighting,
        which captures it; replayed after, but eager while the last
        replay's backward may still have to run."""
        params, buffers = layer_tensors(module)
        key = self.key(params, buffers, x, constants)
        captured = self.graphs.get(key)
        if captured is None:
            seen = self.seen.get(key, 0) + 1
            if seen < CAPTURE_AT:
                if len(self.seen) >= _MAX_KEYS:
                    self.seen.clear()
                self.seen[key] = seen
                return body(x)
            del self.seen[key]
            storages = key[-1]
            self.graphs = {k: v for k, v in self.graphs.items() if k[-1] == storages}
            if [*map(id, params + buffers)] != [*map(id, (*module.parameters(),
                                                           *module.buffers()))]:
                raise ValueError("a body graph needs every parameter and buffer of "
                                 "the module on its children")
            captured = self.graphs[key] = self._capture(body, x, params)
            if self.counted:
                count("train.graph_captures")
        elif captured.busy():
            return body(x)
        token = _Token(captured.replays + 1)
        captured.live = weakref.ref(token)
        if self.counted:
            count("train.graph_replays")
        return _Replay.apply(captured, token, x, *params)

    def _capture(self, body, x: torch.Tensor, params: tuple) -> _Captured:
        c = _Captured()
        c.live, c.replays = None, 0
        c.leaves = tuple(i for i, p in enumerate(params) if p.requires_grad)
        c.x = torch.empty_like(x).requires_grad_(x.requires_grad)
        inputs = ((c.x,) if x.requires_grad else ()) + tuple(params[i] for i in c.leaves)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(x.device)
        before = _launches()
        with torch.enable_grad():
            c.forward, c.out = _capture_graph(lambda: body(c.x), x.device, pool, stream)
        middle = _launches()
        c.grad_out = torch.empty_like(c.out)
        c.backward, c.grads = _capture_graph(
            lambda: torch.autograd.grad(c.out, inputs, c.grad_out, retain_graph=True,
                                        allow_unused=True),
            x.device, pool, stream)
        # The backward was captured retaining its graph, so that no activation it
        # reads was freed and reused inside it, and a second replay reads what the
        # first did. That graph is dropped now: it holds the parameters' gradient
        # accumulators on the capture stream. The activations' memory stays in the
        # graphs' private pool, which only a capture into it allocates from.
        c.out = c.out.detach()
        c.launches = (_delta(before, middle), _delta(middle, _launches()))
        for launches in c.launches:
            _add(launches, -1)  # the capture launched nothing
        return c
