"""Recompute in the port against no recompute and against the
reference's recompute on the CPU, fp32, on the parity `SMALL` config:

* `LlamaConfig.recompute=True`: the loss and every gradient equal the
  no-recompute ones within 1e-6 and the reference's recompute within
  1e-5 (its `_recompute_layer` runs `sdpa_ref` inside the checkpointed
  layer on the CPU); each layer's flash forward runs twice (once more
  in the replay), its dQ and dK/dV once;
* `fleet.utils.recompute` on a plain function and on a module with
  parameters, against the function without it and the reference's
  recompute; `offload=` / `policy=` raise;
* `sdp_kernel(enable_flash=False)` sends mask-free SDPA to `sdpa_ref`,
  and the flash entry is back after the block.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.utils import recompute as ref_recompute
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import flash_attention as tfa

from _torch_parity import SMALL, model_pair

SEQ = 16


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL["vocab_size"], (2, SEQ))
    labels = rng.randint(0, SMALL["vocab_size"], (2, SEQ))
    labels[1, :4] = -100
    return ids, labels


def _port_loss_grads(port, ids, labels):
    port.zero_grad(set_to_none=True)
    loss = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad.numpy().copy()
                         for n, p in port.named_parameters()}


def _counting(monkeypatch):
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name in calls:
        real = getattr(fa, f"flash_{name}")

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(fa, f"flash_{name}", spy)
    return calls


def test_recompute_matches_no_recompute_and_reference(monkeypatch):
    ref, port = model_pair(seed=4, recompute=True, num_hidden_layers=1)
    ids, labels = _batch()
    calls = _counting(monkeypatch)
    loss_rc, grads_rc = _port_loss_grads(port, ids, labels)
    layers = 1
    assert calls == {"fwd": 2 * layers, "dq": layers, "dkv": layers}
    port.cfg.recompute = False
    loss, grads = _port_loss_grads(port, ids, labels)
    assert calls == {"fwd": 3 * layers, "dq": 2 * layers, "dkv": 2 * layers}
    np.testing.assert_allclose(loss_rc, loss, rtol=1e-6, atol=1e-6)
    for name in grads:
        np.testing.assert_allclose(grads_rc[name], grads[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    rl = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    rl.backward()
    np.testing.assert_allclose(loss_rc, float(np.asarray(rl._data)),
                               rtol=1e-5, atol=1e-5)
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(grads_rc[name], np.asarray(p.grad._data),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_fleet_recompute_of_a_function_and_a_module():
    rng = np.random.RandomState(1)
    x0 = rng.randn(4, 16).astype(np.float32)
    w0 = rng.randn(16, 16).astype(np.float32)

    def fn(x, w):
        return torch.tanh(x @ w) * x

    def grads(use_recompute):
        x = torch.from_numpy(x0).requires_grad_()
        w = torch.from_numpy(w0).requires_grad_()
        y = recompute(fn, x, w) if use_recompute else fn(x, w)
        (y * y).sum().backward()
        return y.detach().numpy(), x.grad.numpy(), w.grad.numpy()
    with_rc, without = grads(True), grads(False)
    for a, b in zip(with_rc, without):
        np.testing.assert_array_equal(a, b)
    xr = paddle.to_tensor(x0)
    xr.stop_gradient = False
    wr = paddle.to_tensor(w0)
    wr.stop_gradient = False
    yr = ref_recompute(lambda x, w: paddle.tanh(x @ w) * x, xr, wr)
    (yr * yr).sum().backward()
    for got, want in zip(with_rc, (yr, xr.grad, wr.grad)):
        np.testing.assert_allclose(got, np.asarray(want._data), rtol=1e-5,
                                   atol=1e-5)

    lin = Linear(16, 8, device="cpu", generator=torch.Generator()
                 .manual_seed(0))
    x = torch.from_numpy(x0)
    recompute(lin, x, preserve_rng_state=False).sum().backward()
    g_rc = lin.weight.grad.clone()
    lin.weight.grad = None
    lin(x).sum().backward()
    assert torch.equal(g_rc, lin.weight.grad)
    for kw in (dict(offload=True), dict(policy=object())):
        with pytest.raises(NotImplementedError, match="TPU remat"):
            recompute(fn, x, x, **kw)


def test_sdp_kernel_routes_mask_free_sdpa(monkeypatch):
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 2, 64).astype(np.float32))
               for _ in range(3))
    routes = []
    real_flash, real_ref = tfa.flash.flash_attention_bshd, tfa.sdpa_ref
    monkeypatch.setattr(tfa.flash, "flash_attention_bshd",
                        lambda *a, **kw: routes.append("flash")
                        or real_flash(*a, **kw))
    monkeypatch.setattr(tfa, "sdpa_ref", lambda *a, **kw:
                        routes.append("ref") or real_ref(*a, **kw))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    with F.sdp_kernel(enable_flash=False):
        plain = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    again = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert routes == ["flash", "ref", "flash"]
    torch.testing.assert_close(plain, out, rtol=1e-5, atol=1e-5)
    assert torch.equal(again, out)


def test_sequence_parallel_still_refused():
    cfg = LlamaConfig(**dict(SMALL, num_hidden_layers=1,
                             sequence_parallel=True))
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        model(torch.zeros(1, 8, dtype=torch.long))
