"""The port's MoE routing and layer (`paddle_tpu_torch.distributed.moe`)
against the reference's (`paddle_tpu.distributed.moe`) on the CPU.

The same seeded numpy gates, tokens and expert weights go to both sides:
* dispatch: slot tokens, slot weights, per-expert counts and the
  dispatched slab bitwise, the aux loss within 1e-6 — over random
  gates, an expert that overflows its capacity (earlier tokens win it),
  and gates with exact ties (the lower expert id wins, `lax.top_k`'s
  order);
* combine within 1e-6; `number_count`, `limit_by_capacity`, `TopKGate`
  and `SwitchGate`;
* one `MoELayer` forward and its input, gate and stacked-expert
  gradients within 1e-5 of the reference layer over the same weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import moe as ref_moe
from paddle_tpu.models.qwen2_moe import _ExpertMLP as RefExpert
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.distributed.fleet.mpu import ModelParallelMesh
from paddle_tpu_torch.models.qwen2_moe import _ExpertMLP

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t._data)


def _gates(rng, T, E, scale=1.0):
    logits = (rng.randn(T, E) * scale).astype(np.float32)
    g = np.exp(logits - logits.max(1, keepdims=True))
    return (g / g.sum(1, keepdims=True)).astype(np.float32)


def _dispatch_both(x, g, topk, capacity):
    ref_in, (ref_tok, ref_w), ref_aux = ref_moe.moe_dispatch_combine(
        paddle.to_tensor(x), paddle.to_tensor(g), topk, capacity)
    port_in, info, port_aux = moe.moe_dispatch_combine(
        torch.from_numpy(x), torch.from_numpy(g), topk, capacity)
    return ((_np(ref_in), _np(ref_tok), _np(ref_w), float(_np(ref_aux))),
            (port_in.numpy(), info[0].numpy(), info[1].numpy(),
             port_aux.item()), info)


def _ref_counts(g, topk):
    import jax
    _, idx = jax.lax.top_k(g, topk)
    return _np(ref_moe.number_count(paddle.to_tensor(np.asarray(idx)),
                                    g.shape[1]))


def _tied_gates():
    """Rows of exact ties: uniform rows, two or three equal maxima, and
    equal runner-up gates."""
    E = 8
    rows = [np.full(E, 1.0 / E)]
    for hi in ((1, 5), (0, 7), (2, 3, 6)):
        r = np.full(E, 0.05)
        r[list(hi)] = 0.3
        rows.append(r)
    r = np.full(E, 0.1)
    r[4], r[[0, 2, 7]] = 0.2, 0.15
    rows.append(r)
    g = np.tile(np.stack(rows), (3, 1))
    return (g / g.sum(1, keepdims=True)).astype(np.float32)


# (tokens, experts, topk, capacity, gate scale, seed); the third case's
# capacity is far below the assignments, so experts overflow
DISPATCH_CASES = {"top2": (48, 8, 2, 15, 1.0, 0),
                  "top4_wide": (64, 16, 4, 32, 3.0, 1),
                  "overflow": (48, 8, 2, 3, 1.0, 2),
                  "top1": (32, 8, 1, 8, 0.5, 3)}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_matches_reference_bitwise(case):
    T, E, k, C, scale, seed = DISPATCH_CASES[case]
    rng = np.random.RandomState(seed)
    g = _gates(rng, T, E, scale)
    x = rng.randn(T, 16).astype(np.float32)
    ref, port, info = _dispatch_both(x, g, k, C)
    for name, r, p in zip(("expert_in", "slot_tok", "slot_w"), ref, port):
        np.testing.assert_array_equal(p, r, err_msg=name)
    assert abs(port[3] - ref[3]) <= 1e-6
    counts = moe._route(torch.from_numpy(g), k, C).counts.numpy()
    np.testing.assert_array_equal(counts, _ref_counts(g, k))
    assert info[2].shape == (T, k)


def test_overflow_earlier_tokens_win_capacity():
    """Every token's first choice is expert 0: of its T assignments the
    first C tokens keep their slots, the rest are dropped, as in the
    reference; a dropped assignment adds nothing at combine."""
    T, E, C = 12, 4, 5
    g = np.full((T, E), 0.1, np.float32)
    g[:, 0] = 0.7
    x = np.random.RandomState(0).randn(T, 4).astype(np.float32)
    ref, port, info = _dispatch_both(x, g, 1, C)
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[1][:C], np.arange(C))
    np.testing.assert_array_equal(port[2][C:], 0.0)
    tok_slots = info[2].numpy()[:, 0]
    np.testing.assert_array_equal(tok_slots[:C], np.arange(C))
    assert (tok_slots[C:] == E * C).all()
    out = moe.moe_combine(torch.ones(E, C, 4), info, T).numpy()
    np.testing.assert_array_equal(out[C:], 0.0)
    np.testing.assert_array_equal(out[:C], 1.0)


def test_tied_gates_lower_expert_wins():
    g = _tied_gates()
    x = np.random.RandomState(1).randn(g.shape[0], 8).astype(np.float32)
    for k, C in ((2, 6), (3, 4)):
        ref, port, _ = _dispatch_both(x, g, k, C)
        for name, r, p in zip(("expert_in", "slot_tok", "slot_w"), ref,
                              port):
            np.testing.assert_array_equal(p, r, err_msg=(name, k))
        vals, ids = moe._top_k(torch.from_numpy(g), k)
        assert ids[0].tolist() == list(range(k))            # uniform row
        assert ids[1].tolist()[:2] == [1, 5]
        assert ids[3].tolist()[:3] == [2, 3, 6][:k]
        assert ids[4].tolist()[:3] == [4, 0, 2][:k]


def test_combine_matches_reference():
    T, E, k, C, d = 40, 8, 2, 8, 16
    rng = np.random.RandomState(5)
    g = _gates(rng, T, E)
    x = rng.randn(T, d).astype(np.float32)
    eo = rng.randn(E, C, d).astype(np.float32)
    _, (ref_tok, ref_w), _ = ref_moe.moe_dispatch_combine(
        paddle.to_tensor(x), paddle.to_tensor(g), k, C)
    want = _np(ref_moe.moe_combine(paddle.to_tensor(eo), (ref_tok, ref_w),
                                   T))
    _, info, _ = moe.moe_dispatch_combine(torch.from_numpy(x),
                                          torch.from_numpy(g), k, C)
    got = moe.moe_combine(torch.from_numpy(eo), info, T)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    again = moe.moe_combine(torch.from_numpy(eo), info, T)
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="routes 40 tokens"):
        moe.moe_combine(torch.from_numpy(eo), info, T + 1)


def test_number_count_and_limit_by_capacity():
    ids = np.array([[0, 3], [3, 3], [5, -1], [1, 2]], np.int32)
    want = _np(ref_moe.number_count(paddle.to_tensor(ids), 4))
    got = moe.number_count(torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64
    for cap in (2, 0, 9):
        want_l = _np(ref_moe.limit_by_capacity(paddle.to_tensor(want), cap))
        got_l = moe.limit_by_capacity(got, cap)
        np.testing.assert_array_equal(got_l.numpy(), want_l)
        assert got_l.dtype == got.dtype


@pytest.mark.parametrize("kind", ["topk", "switch"])
def test_gates_match_reference(kind):
    d, E = 16, 6
    rng = np.random.RandomState(7)
    w = (rng.randn(d, E) / 4).astype(np.float32)
    x = rng.randn(10, d).astype(np.float32)
    if kind == "topk":
        ref = ref_moe.TopKGate(d, E, topk=3, capacity_factor=1.5)
        port = moe.TopKGate(d, E, topk=3, capacity_factor=1.5, device="cpu")
    else:
        ref = ref_moe.SwitchGate(d, E, capacity_factor=1.5)
        port = moe.SwitchGate(d, E, capacity_factor=1.5, device="cpu")
    ref.set_state_dict({"wg.weight": w})
    port.load_state_dict({"wg.weight": torch.from_numpy(w)}, strict=True)
    assert (port.topk, port.num_experts, port.capacity_factor) == \
        (ref.topk, ref.num_experts, ref.capacity_factor)
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        _np(ref(paddle.to_tensor(x))), rtol=1e-6, atol=1e-6)


def _expert_weights(rng, E, d, inter):
    return [{"gate_proj.weight": (rng.randn(d, inter) / np.sqrt(d)),
             "up_proj.weight": (rng.randn(d, inter) / np.sqrt(d)),
             "down_proj.weight": (rng.randn(inter, d) / np.sqrt(inter))}
            for _ in range(E)]


@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_moe_layer_forward_and_grads_match_reference(cf):
    """At capacity factor 0.5 every expert overflows: the dropped
    assignments' gradients are zero on both sides."""
    T, d, inter, E, k = 24, 32, 16, 4, 2
    rng = np.random.RandomState(11)
    experts = [{n: a.astype(np.float32) for n, a in w.items()}
               for w in _expert_weights(rng, E, d, inter)]
    wg = (rng.randn(d, E) / np.sqrt(d)).astype(np.float32)
    x = rng.randn(2, T // 2, d).astype(np.float32)
    dout = rng.randn(2, T // 2, d).astype(np.float32)

    paddle.seed(0)
    ref = ref_moe.MoELayer(
        d, experts=[RefExpert(d, inter) for _ in range(E)],
        gate=ref_moe.TopKGate(d, E, topk=k, capacity_factor=cf), topk=k,
        capacity_factor=cf)
    state = {"gate.wg.weight": wg}
    for e, w in enumerate(experts):
        state.update({f"experts.{e}.{n}": a for n, a in w.items()})
    missing, unexpected = ref.set_state_dict(state)
    assert not missing and not unexpected
    rx = paddle.to_tensor(x, stop_gradient=False)
    rout = ref(rx)
    (rout * paddle.to_tensor(dout)).sum().backward()

    port = moe.MoELayer(
        d, experts=[_ExpertMLP(d, inter, device="cpu") for _ in range(E)],
        gate=moe.TopKGate(d, E, topk=k, capacity_factor=cf, device="cpu"),
        topk=k, capacity_factor=cf)
    port.load_state_dict(
        {"gate.wg.weight": torch.from_numpy(wg),
         **{f"experts.{n}": torch.from_numpy(np.stack([w[n] for w in
                                                       experts]))
            for n in experts[0]}}, strict=True)
    px = torch.from_numpy(x).requires_grad_()
    pout = port(px)
    (pout * torch.from_numpy(dout)).sum().backward()

    np.testing.assert_allclose(pout.detach().numpy(), _np(rout), **TOL)
    if cf < 1.0:
        C = max(1, int(cf * T * k / E))
        assert (moe._route(port.gate(px.detach().reshape(T, d)), k, C)
                .counts > C).all()
    np.testing.assert_allclose(port.aux_loss.item(),
                               float(_np(ref.aux_loss)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(px.grad.numpy(), _np(rx.grad), **TOL)
    np.testing.assert_allclose(port.gate.wg.weight.grad.numpy(),
                               _np(ref.gate.wg.weight.grad), **TOL)
    for n in experts[0]:
        mod, leaf = n.split(".")
        want = np.stack([_np(getattr(getattr(ref.experts[e], mod), leaf)
                             .grad) for e in range(E)])
        got = getattr(getattr(port.experts, mod), leaf).grad.numpy()
        np.testing.assert_allclose(got, want, err_msg=n, **TOL)


def test_stacked_experts_build_equals_stacked_modules():
    """`build` makes each expert as its own module would be made, from
    one generator in expert order, straight into the stack; the template
    stays on `meta`, out of the state dict."""
    def factory(**kw):
        return _ExpertMLP(8, 4, **kw)
    built = moe.StackedExperts.build(
        factory, 3, device="cpu", generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    stacked = moe.StackedExperts.from_modules(
        [factory(device="cpu", generator=g) for _ in range(3)])
    assert len(built) == 3
    assert built.state_dict().keys() == stacked.state_dict().keys() == {
        "gate_proj.weight", "up_proj.weight", "down_proj.weight"}
    for name, t in built.state_dict().items():
        assert torch.equal(t, stacked.state_dict()[name]), name
    assert built.up_proj.weight.shape == (3, 8, 4)
    assert next(built.template.parameters()).device.type == "meta"
    x = torch.randn(3, 5, 8)
    y = built(x)
    one = factory(device="cpu")
    one.load_state_dict({n: t[1] for n, t in built.state_dict().items()})
    torch.testing.assert_close(y[1], one(x[1]), rtol=1e-6, atol=1e-6)


def test_moe_layer_refuses_expert_parallelism():
    experts = [_ExpertMLP(8, 4, device="cpu") for _ in range(2)]
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        moe.MoELayer(8, experts=experts, group=object())
    mesh = ModelParallelMesh(2, 0, None, None, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        moe.MoELayer(8, experts=experts, mesh=mesh)
    with pytest.raises(ValueError, match="experts list required"):
        moe.MoELayer(8)
    layer = moe.MoELayer(8, experts=experts, topk=1)
    assert layer.gate.wg.weight.device.type == "cpu"
    assert layer.num_experts == 2 and layer.topk == 1
    out = layer(torch.randn(3, 8))
    assert out.shape == (3, 8) and layer.aux_loss is not None
