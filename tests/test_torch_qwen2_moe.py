"""The port's Qwen2-MoE training path against the reference on the CPU.

Identical seeded fp32 weights (the reference's per-expert arrays carried
through `models/convert.py` into the port's stacked experts) on a small
config — `qwen2_moe_tiny` at hidden 128 over 2 heads and 1 KV head
(head_dim 64, G 2), batch 2 x 32, labels with some -100 positions. The
reference runs once per module (its first forward + backward compiles
for ~17 s here), and every test compares against its arrays:
* the logits within 1e-5; the loss with the router aux loss within
  1e-5; each sparse layer's aux within 1e-6; layer 0's routing (slot
  tokens and counts equal, slot weights within 1e-5, from each side's
  own gates);
* every parameter gradient (routed experts, `wg`, the shared expert and
  its gate, the qkv biases, the embedding, the head) within 1e-5;
* three fused-AdamW steps: each loss within 1e-5, the final parameters
  bounded as in tests/test_torch_llama_train.py;
* `decoder_sparse_step=2` (layer 0 dense); `ParallelCrossEntropy`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import moe as ref_moe
from paddle_tpu.distributed.fleet.mpu import \
    ParallelCrossEntropy as RefParallelCrossEntropy
from paddle_tpu.models.qwen2_moe import Qwen2MoeForCausalLM as RefQwen2Moe
from paddle_tpu.models.qwen2_moe import qwen2_moe_tiny as ref_tiny
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.distributed.fleet.mpu import (ModelParallelMesh,
                                                    ParallelCrossEntropy)
from paddle_tpu_torch.models import (Qwen2MoeForCausalLM, qwen2_moe_a14b,
                                     qwen2_moe_tiny)
from paddle_tpu_torch.models.convert import (expected_shapes,
                                             from_jax_state_dict)

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1)
BATCH, SEQ, LR, STEPS = 2, 32, 1e-3, 3


def seeded_state(ref, seed):
    """Seeded fp32 arrays for every reference parameter: matrices scaled
    by 1/sqrt(fan_in), norm weights near 1, biases near 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in ref.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            a = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) / np.sqrt(shape[0])
        out[name] = a.astype(np.float32)
    return out


def qwen_pair(seed=0, **overrides):
    """(reference model, port model on the CPU, port config) with
    identical fp32 weights."""
    kw = dict(SMALL, **overrides)
    paddle.seed(seed)
    ref = RefQwen2Moe(ref_tiny(**kw))
    missing, unexpected = ref.set_state_dict(seeded_state(ref, seed))
    assert not missing and not unexpected
    exported = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    cfg = qwen2_moe_tiny(**kw)
    port = Qwen2MoeForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    port.load_state_dict(from_jax_state_dict(exported, cfg), strict=True)
    return ref, port, cfg


def _batch(seed, vocab):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (BATCH, SEQ))
    labels = rng.randint(0, vocab, (BATCH, SEQ))
    labels[0, :5] = -100
    labels[1, 20:23] = -100
    return ids, labels


def _capture(module, store):
    """Record the module's output of each forward (an instance-level
    `forward` wraps the class's)."""
    inner = module.forward

    def forward(x):
        out = inner(x)
        store.append(out)
        return out
    module.forward = forward


def _ref_grads(ref):
    return {n: np.asarray(p.grad._data) for n, p in ref.named_parameters()}


def _stacked(ref_arrays, port_name, E):
    """The reference's arrays under a port name: a stacked expert name
    gathers its E per-expert arrays."""
    if ".moe.experts." not in port_name:
        return ref_arrays[port_name]
    head, leaf = port_name.split(".moe.experts.")
    return np.stack([ref_arrays[f"{head}.moe.experts.{e}.{leaf}"]
                     for e in range(E)])


def _step(ref, port, ids, labels):
    rl = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    rl.backward()
    pl = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    pl.backward()
    return float(np.asarray(rl._data)), pl.item()


@pytest.fixture(scope="module")
def run():
    ref, port, cfg = qwen_pair(seed=0)
    ids, labels = _batch(0, cfg.vocab_size)
    out = {"cfg": cfg, "losses": []}
    ref_gates, port_gates, ref_logits, port_logits = [], [], [], []
    _capture(ref.model.layers[0].mlp.moe.gate, ref_gates)
    _capture(port.model.layers[0].mlp.moe.gate, port_gates)
    _capture(ref.lm_head, ref_logits)
    _capture(port.lm_head, port_logits)
    ref_opt = paddle.optimizer.AdamW(LR, parameters=ref.parameters(),
                                     fused=True)
    from paddle_tpu_torch.optimizer import AdamW
    port_opt = AdamW(LR, parameters=port.parameters(), fused=True)
    for step in range(STEPS):
        out["losses"].append(_step(ref, port, ids, labels))
        if step == 0:
            out["aux"] = ([float(np.asarray(a._data))
                           for a in ref.model.aux_losses()],
                          [a.item() for a in port.model.aux_losses()])
            out["gates"] = (np.asarray(ref_gates[0]._data),
                            port_gates[0].detach().numpy())
            out["logits"] = (np.asarray(ref_logits[0]._data),
                             port_logits[0].detach().numpy())
            out["grads"] = (_ref_grads(ref),
                            {n: p.grad.numpy().copy()
                             for n, p in port.named_parameters()})
        ref_opt.step()
        ref_opt.clear_grad()
        port_opt.step()
        port_opt.clear_grad()
    out["final"] = ({n: np.asarray(p._data)
                     for n, p in ref.named_parameters()},
                    {n: p.detach().numpy()
                     for n, p in port.named_parameters()})
    return out


def test_logits_match_reference(run):
    ref_logits, port_logits = run["logits"]
    assert port_logits.shape == (BATCH, SEQ, run["cfg"].vocab_size)
    np.testing.assert_allclose(port_logits, ref_logits, **TOL)


def test_loss_with_aux_matches_reference(run):
    ref_loss, port_loss = run["losses"][0]
    np.testing.assert_allclose(port_loss, ref_loss, **TOL)
    ref_aux, port_aux = run["aux"]
    assert len(port_aux) == len(ref_aux) == run["cfg"].num_hidden_layers
    np.testing.assert_allclose(port_aux, ref_aux, rtol=0, atol=1e-6)


def test_layer0_routing_matches_reference(run):
    cfg = run["cfg"]
    ref_g, port_g = run["gates"]
    np.testing.assert_allclose(port_g, ref_g, rtol=1e-6, atol=1e-6)
    tokens = BATCH * SEQ
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    capacity = max(1, int(cfg.capacity_factor * tokens * k / E))
    x = np.zeros((tokens, 1), np.float32)
    _, (ref_tok, ref_w), _ = ref_moe.moe_dispatch_combine(
        paddle.to_tensor(x), paddle.to_tensor(ref_g), k, capacity)
    r = moe._route(torch.from_numpy(port_g), k, capacity)
    np.testing.assert_array_equal(r.slot_tok.numpy(),
                                  np.asarray(ref_tok._data))
    np.testing.assert_allclose(r.slot_w.numpy(), np.asarray(ref_w._data),
                               **TOL)
    import jax
    _, idx = jax.lax.top_k(ref_g, k)
    np.testing.assert_array_equal(
        r.counts.numpy(), np.bincount(np.asarray(idx).ravel(),
                                      minlength=E))


def test_every_gradient_matches_reference(run):
    ref_g, port_g = run["grads"]
    E = run["cfg"].num_experts
    assert {n for n in port_g} == set(expected_shapes(run["cfg"]))
    for name in ("model.layers.0.mlp.moe.experts.gate_proj.weight",
                 "model.layers.1.mlp.moe.gate.wg.weight",
                 "model.layers.0.mlp.shared_expert.shared_expert_gate.weight",
                 "model.layers.1.self_attn.k_proj.bias",
                 "model.embed_tokens.weight", "lm_head.weight"):
        assert np.abs(port_g[name]).max() > 0, name
    for name, got in port_g.items():
        np.testing.assert_allclose(got, _stacked(ref_g, name, E),
                                   err_msg=name, **TOL)


def test_fused_adamw_trajectory_matches_reference(run):
    losses = np.array(run["losses"])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], **TOL)
    assert np.all(np.diff(losses[:, 1]) < 0)
    ref_p, port_p = run["final"]
    E = run["cfg"].num_experts
    close = total = 0
    for name, got in port_p.items():
        diff = np.abs(got - _stacked(ref_p, name, E))
        assert diff.max() <= 2 * LR, (name, diff.max())
        close += int((diff <= 1e-5).sum())
        total += diff.size
    assert close >= 0.999 * total, (close, total)


def test_dense_layer_with_sparse_step_2():
    """decoder_sparse_step=2: layer 0 is a dense SwiGLU, layer 1 sparse;
    one aux loss; loss and gradients as the reference's."""
    ref, port, cfg = qwen_pair(seed=1, decoder_sparse_step=2)
    assert [layer.is_sparse for layer in port.model.layers] == [False, True]
    assert "model.layers.0.mlp.gate_proj.weight" in expected_shapes(cfg)
    ids, labels = _batch(1, cfg.vocab_size)
    ref_loss, port_loss = _step(ref, port, ids, labels)
    np.testing.assert_allclose(port_loss, ref_loss, **TOL)
    assert len(port.model.aux_losses()) == 1
    ref_g = _ref_grads(ref)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   _stacked(ref_g, name, cfg.num_experts),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("ignore_index", [-100, 3])
def test_parallel_cross_entropy_matches_reference(ignore_index):
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(2, 5, 11)).astype(np.float32)
    label = rng.randint(0, 11, (2, 5, 1))
    label[0, 1, 0] = ignore_index
    want = np.asarray(RefParallelCrossEntropy(ignore_index=ignore_index)(
        paddle.to_tensor(logits), paddle.to_tensor(label))._data)
    got = ParallelCrossEntropy(ignore_index=ignore_index)(
        torch.from_numpy(logits), torch.from_numpy(label))
    assert got.shape == (2, 5, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert got[0, 1, 0].item() == 0.0
    got2 = ParallelCrossEntropy(ignore_index=ignore_index)(
        torch.from_numpy(logits), torch.from_numpy(label[..., 0]))
    assert torch.equal(got, got2)


def test_parallel_cross_entropy_refuses_a_split_vocab():
    mesh = ModelParallelMesh(2, 0, None, None, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="training tensor"):
        ParallelCrossEntropy(mesh=mesh)
    with pytest.raises(NotImplementedError, match="training tensor"):
        ParallelCrossEntropy(mp_group=object())
    one = ModelParallelMesh(1, 0, None, None, torch.device("cpu"))
    assert ParallelCrossEntropy(mesh=one).ignore_index == -100


def test_converter_and_construction():
    """The converter's checks; the A14B geometry; entry points default to
    the card (none here)."""
    cfg = qwen2_moe_tiny(**SMALL)
    paddle.seed(0)
    ref = RefQwen2Moe(ref_tiny(**SMALL))
    state = seeded_state(ref, 0)
    assert len(state) == 55 and len(expected_shapes(cfg)) == 37
    conv = from_jax_state_dict(state, cfg)
    stacked = conv["model.layers.1.mlp.moe.experts.down_proj.weight"]
    assert stacked.shape == (4, 32, 128)
    np.testing.assert_array_equal(
        stacked[2].numpy(), state["model.layers.1.mlp.moe.experts.2."
                                  "down_proj.weight"])
    broken = dict(state)
    del broken["model.layers.0.mlp.moe.experts.3.up_proj.weight"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_state_dict(broken, cfg)
    broken = dict(state, **{"model.layers.0.mlp.moe.experts.0.up_proj."
                            "weight": np.zeros((128, 31), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_state_dict(broken, cfg)
    with pytest.raises(ValueError, match="not ported"):
        expected_shapes(cfg, wq="int8")
    big = qwen2_moe_a14b(num_hidden_layers=1)
    n = sum(int(np.prod(s)) for s in expected_shapes(big).values())
    assert 3.09e9 < n < 3.11e9
    with pytest.raises(RuntimeError, match="none is available"):
        Qwen2MoeForCausalLM(cfg)
