"""The port's Llama training path against the reference on the CPU.

Identical seeded fp32 weights (through models/convert.py) on both sides,
the parity `SMALL` config at seq 64, labels with some -100 positions:

* the loss and every parameter gradient of one forward/backward within
  rtol/atol 1e-5, tied and untied heads (the reference runs its flash
  kernels in interpret mode; the port their plain versions);
* three fused-AdamW steps (untied, run once for the module): each
  step's loss within 1e-5, and the final parameters within 2 * lr
  everywhere and within 1e-5 for 99.9% of the elements. The first bound
  is one Adam step whose direction flips: early Adam updates are
  sign-like (m / sqrt(v) is +-1 at step 1), so a gradient within
  rounding of 0 can take opposite steps on the two sides.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW

from _torch_parity import SMALL, model_pair

TOL = dict(rtol=1e-5, atol=1e-5)
SEQ, LR, STEPS = 64, 1e-3, 3


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL["vocab_size"], (2, SEQ))
    labels = rng.randint(0, SMALL["vocab_size"], (2, SEQ))
    labels[0, :5] = -100
    labels[1, 30:33] = -100
    return ids, labels


def _loss_and_grads(ref, port, ids, labels):
    rl = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    rl.backward()
    pl = port(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    pl.backward()
    return (float(np.asarray(rl._data)), pl.item(),
            {n: np.asarray(p.grad._data) for n, p in ref.named_parameters()},
            {n: p.grad.numpy().copy() for n, p in port.named_parameters()})


@pytest.fixture(scope="module")
def trajectory():
    ref, port = model_pair(seed=0)
    ids, labels = _batch(0)
    ref_opt = paddle.optimizer.AdamW(LR, parameters=ref.parameters(),
                                     fused=True)
    port_opt = AdamW(LR, parameters=port.parameters(), fused=True)
    out = {"losses": []}
    for step in range(STEPS):
        got = _loss_and_grads(ref, port, ids, labels)
        if step == 0:
            out["first"] = got
        out["losses"].append(got[:2])
        ref_opt.step()
        ref_opt.clear_grad()
        port_opt.step()
        port_opt.clear_grad()
    out["final"] = ({n: np.asarray(p._data)
                     for n, p in ref.named_parameters()},
                    {n: p.detach().numpy()
                     for n, p in port.named_parameters()})
    out["state_keys"] = (set(ref_opt.state_dict()),
                         set(port_opt.state_dict()))
    return out


@pytest.mark.parametrize("tied", [False, True])
def test_loss_and_every_gradient_match_reference(trajectory, tied):
    if tied:
        ref, port = model_pair(seed=1, tie_word_embeddings=True)
        rl, pl, rg, pg = _loss_and_grads(ref, port, *_batch(1))
    else:
        rl, pl, rg, pg = trajectory["first"]
    np.testing.assert_allclose(pl, rl, **TOL)
    assert rg.keys() == pg.keys() and ("lm_head.weight" in pg) != tied
    for name in rg:
        np.testing.assert_allclose(pg[name], rg[name], err_msg=name, **TOL)


def test_fused_adamw_trajectory_matches_reference(trajectory):
    losses = np.array(trajectory["losses"])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], **TOL)
    assert np.all(np.diff(losses[:, 1]) < 0)
    ref_p, port_p = trajectory["final"]
    close = total = 0
    for name, want in ref_p.items():
        diff = np.abs(port_p[name] - want)
        assert diff.max() <= 2 * LR, (name, diff.max())
        close += int((diff <= 1e-5).sum())
        total += diff.size
    assert close >= 0.999 * total, (close, total)
    ref_keys, port_keys = trajectory["state_keys"]
    assert ref_keys == port_keys


def test_unported_training_options_raise():
    """sequence_parallel is still refused; recompute and the KV-cache
    forward (once refused here too) now run (tests/test_torch_recompute.py
    and tests/test_torch_generate.py hold them against the reference)."""
    kw = dict(SMALL, num_hidden_layers=1)
    ids = torch.zeros(1, 8, dtype=torch.long)
    model = LlamaForCausalLM(LlamaConfig(**kw, sequence_parallel=True),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        model(ids)
    model = LlamaForCausalLM(LlamaConfig(**kw, recompute=True), device="cpu")
    assert model(ids).shape == (1, 8, SMALL["vocab_size"])
    model = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    logits, caches = model(ids, caches=model._new_caches(1))
    assert logits.shape == (1, 8, SMALL["vocab_size"])
    assert caches[0][0].shape[1] == 8
    assert model(ids).shape == (1, 8, SMALL["vocab_size"])
