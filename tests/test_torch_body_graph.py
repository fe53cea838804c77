"""The victim's body graphs (models/body_graph.py) on the CPU: the rule
that picks the graph route, the capture key, and the replay's plumbing.

This host has no CUDA device, so no graph is captured here. The route's
rule is tested on stand-ins of a CUDA input. The replay's ``Function``,
its sightings, counters, copies and refusals are tested with the two
graphs stood in for by a recomputation of the body (``recompute_capture``):
a step through that stand-in must equal the eager step bit for bit, as a
step through the real graphs must on the card (tests/test_torch_cuda.py).
"""

import copy
import pickle
from types import SimpleNamespace

import pytest
import torch

from geometric_adv_tpu_torch.models import body_graph as bg
from geometric_adv_tpu_torch.models import layers
from geometric_adv_tpu_torch.models.layers import FCStack, PointMLP, takes_body_graph
from geometric_adv_tpu_torch.models.pointnet_ae import PointNetAE, init_weights
from geometric_adv_tpu_torch.ops.chamfer import chamfer_loss_per_pc
from geometric_adv_tpu_torch.utils.profiling import counters, reset_counters


def cuda_like(**kw):
    """Stands in for a contiguous float32 CUDA input unless changed."""
    base = dict(device=torch.device("cuda", 0), dtype=torch.float32, contiguous=True)
    base.update(kw)
    return SimpleNamespace(device=base["device"], dtype=base["dtype"],
                           is_contiguous=lambda: base["contiguous"])


def make_module(kind, dtype="float32"):
    if kind == "encoder":
        return PointMLP(3, [8, 16, 4], dtype=dtype).train()
    return FCStack(4, [8, 8, 12], dtype=dtype).train()


CASES = ["cuda_train", "cpu", "eval", "no_grad", "mesh", "bf16_module", "bf16_input",
         "not_contiguous", "layer_hook", "global_hook", "composed_bn_relu"]


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
@pytest.mark.parametrize("case", CASES)
def test_graph_route_only_in_train_mode_on_one_process_at_float32_on_the_card(
        kind, case, monkeypatch):
    module = make_module(kind, "bfloat16" if case == "bf16_module" else "float32")
    module.train(case != "eval")
    if case == "mesh":
        layers.set_batch_norm_mesh(module, SimpleNamespace(size=2))
    if case == "layer_hook":
        next(module.children()).register_forward_hook(lambda *a: None)
    if case == "global_hook":
        handle = torch.nn.modules.module.register_module_forward_hook(lambda *a: None)
    if case == "composed_bn_relu":
        monkeypatch.setattr(layers, "takes_fused_bn_relu", lambda bn, x: False)
    x = cuda_like(**{"cpu": dict(device=torch.device("cpu")),
                     "bf16_input": dict(dtype=torch.bfloat16),
                     "not_contiguous": dict(contiguous=False)}.get(case, {}))
    try:
        with torch.set_grad_enabled(case != "no_grad"):
            got = takes_body_graph(module, x)
    finally:
        if case == "global_hook":
            handle.remove()
    # the decoder has no batch norm: the fused route's rule does not bind it
    want = case == "cuda_train" or (kind == "decoder" and case == "composed_bn_relu")
    assert got is want


def test_a_mesh_of_one_process_keeps_the_route():
    module = make_module("decoder")
    layers.set_batch_norm_mesh(module, SimpleNamespace(size=1))
    assert module.mesh is None and takes_body_graph(module, cuda_like())


def test_training_on_the_cpu_captures_nothing():
    """The port's CPU path: train steps of the victim stay eager, with no
    sighting recorded and no graph counter."""
    reset_counters()
    model = init_weights(PointNetAE(n_points=32), torch.Generator().manual_seed(0)).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.rand(4, 32, 3)
    for _ in range(4):
        opt.zero_grad(set_to_none=True)
        model(x)[0].sum().backward()
        opt.step()
    for body in (model.encoder, model.decoder):
        assert body.graphs.seen == {} and body.graphs.graphs == {}
    assert not any(k.startswith("train.graph") for k in counters())


def test_copies_of_a_module_start_with_no_graphs():
    model = PointNetAE(n_points=32)
    model.encoder.graphs.seen["key"] = 1
    for twin in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert twin.encoder.graphs is not model.encoder.graphs
        assert twin.encoder.graphs.seen == {} and twin.encoder.graphs.counted
        assert not twin.decoder.graphs.counted


def test_capture_key_follows_storages_and_settings_not_values():
    module = make_module("encoder")
    x = torch.rand(2, 10, 3)

    def key(x=x, constants=()):
        return bg.BodyGraphs.key(*bg.layer_tensors(module), x, constants)

    first = key()
    module.load_state_dict(make_module("encoder").state_dict())  # copies in place
    assert key() == first
    assert key(constants=((1e-5, 0.5),)) != first
    assert key(torch.rand(3, 10, 3)) != first
    assert key(x.clone().requires_grad_()) != first
    assert key(x.double()) != first
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 on
        assert key() != first
    finally:
        torch.set_float32_matmul_precision(saved)
    assert key() == first
    module.bn_1.weight.requires_grad_(False)
    assert key() != first
    module.bn_1.weight.requires_grad_(True)
    assert key() == first
    module.conv_0.weight = torch.nn.Parameter(module.conv_0.weight.detach().clone())
    assert key() != first


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_tensors_are_the_modules_parameters_and_buffers(kind):
    module = make_module(kind)
    params, buffers = bg.layer_tensors(module)
    assert [*map(id, params)] == [*map(id, module.parameters())]
    assert [*map(id, buffers)] == [*map(id, module.buffers())]


def test_a_module_with_tensors_below_its_children_is_refused():
    """A tensor that ``layer_tensors`` does not see would be baked into the
    graphs as a constant: the capture refuses such a module."""
    module = torch.nn.Sequential(torch.nn.Sequential(torch.nn.Linear(3, 2)))
    graphs = bg.BodyGraphs()
    with pytest.raises(ValueError, match="on its children"):
        for _ in range(bg.CAPTURE_AT):
            graphs.call(module, module, torch.rand(4, 3))


def test_copies_are_fresh_and_equal():
    static = [torch.rand(3, 4), None, torch.rand(5), torch.rand(2, 2, 2)]
    got = bg._copies(static)
    assert got[1] is None
    for t, u in zip(static, got):
        if t is not None:
            assert torch.equal(t, u) and u.shape == t.shape
            assert u.data_ptr() != t.data_ptr() and u.is_contiguous()
    static[0].add_(1.0)
    assert not torch.equal(static[0], got[0])


def recompute_capture(self, body, x, params):
    """``BodyGraphs._capture`` with the two graphs stood in for on the CPU:
    the forward's replay runs ``body`` again on the static input and writes
    its output into the static output; the backward's takes that run's
    gradients into the static gradients. The static buffers come to be at
    the first replay (a capture runs nothing)."""
    c = bg._Captured()
    c.live, c.replays, c.out, c.grads, c.launches = None, 0, None, None, ([], [])
    c.leaves = tuple(i for i, p in enumerate(params) if p.requires_grad)
    c.x = torch.empty_like(x).requires_grad_(x.requires_grad)
    inputs = ((c.x,) if x.requires_grad else ()) + tuple(params[i] for i in c.leaves)
    run = {}

    def forward():
        with torch.enable_grad():
            run["out"] = body(c.x)
        if c.out is None:
            c.out, c.grad_out = run["out"].detach().clone(), torch.empty_like(run["out"])
        else:
            c.out.copy_(run["out"])

    def backward():
        grads = torch.autograd.grad(run["out"], inputs, c.grad_out, retain_graph=True,
                                    allow_unused=True)
        if c.grads is None:
            c.grads = [None if g is None else g.clone() for g in grads]
        else:
            for held, g in zip(c.grads, grads):
                held.copy_(g)

    c.forward, c.backward = SimpleNamespace(replay=forward), SimpleNamespace(replay=backward)
    return c


def train_steps(route, steps, monkeypatch, batch=5, n=32):
    """``steps`` Adam steps of a small victim on the chamfer loss, each on a
    batch of its own, with the body graphs stood in for (``route``
    "graphs") or eager; -> (losses, the model, the optimizer, hook calls
    by name, the reconstructions returned)."""
    if route == "graphs":
        monkeypatch.setattr(layers, "takes_body_graph",
                            lambda m, x: m.training and torch.is_grad_enabled())
        monkeypatch.setattr(bg.BodyGraphs, "_capture", recompute_capture)
    reset_counters()
    model = init_weights(PointNetAE(n_points=n, encoder_filters=[8, 16, 8],
                                    decoder_sizes=[16, 16]),
                         torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    calls = {"model": 0, "encoder": 0, "before": 0, "after": 0}
    model.register_forward_pre_hook(lambda *a: calls.__setitem__("model", calls["model"] + 1))
    model.encoder.register_forward_pre_hook(
        lambda *a: calls.__setitem__("encoder", calls["encoder"] + 1))
    opt.register_step_pre_hook(lambda *a: calls.__setitem__("before", calls["before"] + 1))
    opt.register_step_post_hook(lambda *a: calls.__setitem__("after", calls["after"] + 1))
    gen = torch.Generator().manual_seed(1)
    losses, recons = [], []
    for _ in range(steps):
        x = torch.rand(batch, n, 3, generator=gen)
        model.train()
        recon, _, _ = model(x)
        loss = chamfer_loss_per_pc(recon, x).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        model.eval()
        losses.append(loss.detach())
        recons.append((recon.detach(), recon.detach().clone()))
    return losses, model, opt, calls, recons


def test_a_replayed_step_is_the_eager_step_bit_for_bit(monkeypatch):
    """Eight steps through the stood-in graphs against eight eager ones:
    losses, parameters, Adam's moments and the running statistics equal
    bit for bit; the hooks on the model, the encoder and the optimizer
    fire once a step; one capture and six replays counted; a returned
    reconstruction unchanged by the later steps."""
    steps = 8
    la, ma, oa, ca, _ = train_steps("eager", steps, monkeypatch)
    lb, mb, ob, cb, recons = train_steps("graphs", steps, monkeypatch)
    assert counters()["train.graph_captures"] == 1
    assert counters()["train.graph_replays"] == steps - (bg.CAPTURE_AT - 1)
    assert len(mb.encoder.graphs.graphs) == len(mb.decoder.graphs.graphs) == 1
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for (name, t), u in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(t, u), name
    for p, q in zip(ma.parameters(), mb.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(oa.state[p][k], ob.state[q][k])
    assert ca == cb == {"model": steps, "encoder": steps, "before": steps, "after": steps}
    assert all(torch.equal(got, kept) for got, kept in recons)


def test_another_batch_size_stays_eager_until_its_third_sighting(monkeypatch):
    _, model, _, _, _ = train_steps("graphs", 3, monkeypatch)
    assert counters()["train.graph_replays"] == 1
    model.train()
    x = torch.rand(7, 32, 3)
    for seen in (1, 2):
        model(x)[0].sum().backward()
        assert counters()["train.graph_replays"] == 1
        assert seen in model.encoder.graphs.seen.values()
    model(x)[0].sum().backward()
    assert counters()["train.graph_captures"] == 2
    assert counters()["train.graph_replays"] == 2


def test_a_replay_waits_for_the_backward_of_the_last_one(monkeypatch):
    """Two forwards before one backward over both: the second forward runs
    eager, since the first replay's backward still has to read the graphs'
    activations; the gradients equal the eager run's."""
    grads = {}
    for route in ("eager", "graphs"):
        _, model, _, _, _ = train_steps(route, 3, monkeypatch)
        model.train()
        xs = torch.rand(2, 5, 32, 3, generator=torch.Generator().manual_seed(3))
        replays = counters().get("train.graph_replays", 0)
        total = model(xs[0])[1].sum() + model(xs[1])[1].sum()
        if route == "graphs":
            assert counters()["train.graph_replays"] == replays + 1
        total.backward()
        grads[route] = [p.grad.clone() for p in model.parameters()]
        assert counters().get("train.graph_replays", 0) == replays + (route == "graphs")
    for a, b in zip(grads["eager"], grads["graphs"]):
        assert torch.equal(a, b)


def test_a_retained_backward_runs_again_until_a_later_replay(monkeypatch):
    """``retain_graph``: a replay's backward taken twice gives twice the
    eager gradients; taken again after a later forward replay, which
    overwrote the activations it reads, it raises."""
    grads = {}
    for route in ("eager", "graphs"):
        _, model, _, _, _ = train_steps(route, 3, monkeypatch)
        model.train()
        x = torch.rand(5, 32, 3, generator=torch.Generator().manual_seed(4))
        loss = model(x)[1].sum()
        loss.backward(retain_graph=True)
        loss.backward(retain_graph=True)
        grads[route] = [p.grad.clone() for p in model.parameters()]
    for a, b in zip(grads["eager"], grads["graphs"]):
        assert torch.equal(a, b)
    model(x)[1].sum().backward()  # a later replay
    with pytest.raises(RuntimeError, match="backward ran again"):
        loss.backward()


def test_a_capture_takes_back_the_launches_a_replay_then_counts(monkeypatch):
    """A counted wrapper called while capturing is charged nothing then,
    and its captured launches at each replay."""
    def wrapper():
        wrapper.launches += 1

    wrapper.launches = 0
    monkeypatch.setattr(bg.build, "COUNTED", [wrapper])

    def capture_graph(fn, device, pool, stream):
        wrapper()  # as a kernel wrapper called inside fn would
        return SimpleNamespace(replay=lambda: None), fn()

    monkeypatch.setattr(bg, "_capture_graph", capture_graph)
    monkeypatch.setattr(bg.torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(bg.torch.cuda, "Stream", lambda device: None)
    module = torch.nn.Linear(3, 2)
    x = torch.rand(4, 3)
    c = bg.BodyGraphs()._capture(module, x, tuple(module.parameters()))
    assert wrapper.launches == 0
    assert c.launches == ([(wrapper, 1)], [(wrapper, 1)])
    c.live = None
    out = bg._Replay.apply(c, bg._Token(1), x, *module.parameters())
    assert wrapper.launches == 1
    out.sum().backward()
    assert wrapper.launches == 2
