"""The port's KV-cache forward and `generate` against the reference on
the CPU, fp32, on the parity `SMALL` config (identical weights through
models/convert.py):

* the KV-cache forward's logits in both modes — concatenated caches
  (eager generate) and the fixed buffer written at `cache_pos`
  (jit_generate) — for a prefill and a decode step, within 1e-5;
* greedy `generate` tokens, eager and `use_jit=True`, and the EOS
  padding (one row stopping early; every row stopping early) identical
  to the reference's;
* `generate` equals the argmax of a full forward, as
  tests/test_llama.py checks the reference;
* sampled runs with one seed identical to each other (eager and
  use_jit too), every sampled token inside the top-k / top-p set of the
  logits it was drawn from.

The reference runs under its own `sdp_kernel(enable_flash=False)`
(its prefill would run the interpret-mode Pallas kernel), except in
the first test, which keeps its kernel route for the concatenated
prefill.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional.flash_attention import sdp_kernel
from paddle_tpu_torch.models import generation

from _torch_parity import SMALL, model_pair

S0, N = 16, 6
KV, HD = SMALL["num_key_value_heads"], \
    SMALL["hidden_size"] // SMALL["num_attention_heads"]


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=3)


def _prompt(b=2, seed=0):
    return np.random.RandomState(seed).randint(0, SMALL["vocab_size"],
                                               (b, S0))


def _ref_caches(b, length):
    import jax.numpy as jnp
    return [(paddle.Tensor(jnp.zeros((b, length, KV, HD), jnp.float32)),
             paddle.Tensor(jnp.zeros((b, length, KV, HD), jnp.float32)))
            for _ in range(SMALL["num_hidden_layers"])]


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.numpy()


@pytest.mark.parametrize("mode", ["concat", "fixed"])
def test_kv_cache_forward_logits_match_reference(pair, mode):
    ref, port = pair
    ids = _prompt()
    steps = [ids, ids[:, -1:]]
    fixed = mode == "fixed"
    rc = _ref_caches(2, S0 + 1 if fixed else 0)
    pc = port._new_caches(2, S0 + 1 if fixed else 0)
    pos = 0
    for x in steps:
        kw = dict(cache_pos=pos) if fixed else {}
        rl, rc = ref(paddle.to_tensor(x), caches=rc, **kw)
        with torch.no_grad():
            pl, pc = port(torch.from_numpy(x), caches=pc, **kw)
        np.testing.assert_allclose(pl.numpy(), _np(rl), rtol=1e-5,
                                   atol=1e-5)
        pos += x.shape[1]
    assert pc[0][0].shape == (2, S0 + 1, KV, HD)
    if not fixed:
        np.testing.assert_allclose(pc[1][1].numpy(), _np(rc[1][1]),
                                   rtol=1e-5, atol=1e-5)


def test_greedy_tokens_and_eos_padding_match_reference(pair):
    """Two rows through the reference's eager loop, row 0 stopping at
    its third token and row 1 running on; one row through its jit
    loop, stopping early and padded. The port's eager and use_jit runs
    give the same tokens in both cases."""
    ref, port = pair
    ids = _prompt()
    greedy = port.generate(torch.from_numpy(ids), max_new_tokens=N)
    eos = int(greedy[0, S0 + 2])
    for rows, use_jit in ((2, False), (1, True)):
        with sdp_kernel(enable_flash=False):
            want = _np(ref.generate(paddle.to_tensor(ids[:rows]),
                                    max_new_tokens=N, eos_token_id=eos,
                                    use_jit=use_jit))
        for jit in (False, True):
            got = port.generate(torch.from_numpy(ids[:rows]),
                                max_new_tokens=N, eos_token_id=eos,
                                use_jit=jit).numpy()
            np.testing.assert_array_equal(got, want)
        assert got.shape == (rows, S0 + N)
        assert np.all(got[0, S0 + 2:] == eos)
        np.testing.assert_array_equal(got[:, :S0 + 3],
                                      greedy[:rows, :S0 + 3].numpy())


def test_generate_matches_full_forward_argmax(pair):
    _, port = pair
    ids = torch.from_numpy(_prompt(seed=1))
    out = port.generate(ids, max_new_tokens=N)
    seq = ids
    with torch.no_grad():
        for _ in range(N):
            nxt = port(seq)[:, -1].argmax(-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
    assert torch.equal(out, seq)


def test_sampled_runs_repeat_and_stay_in_the_nucleus(pair, monkeypatch):
    _, port = pair
    ids = torch.from_numpy(_prompt(seed=2))
    kw = dict(max_new_tokens=N, temperature=0.8, top_k=20, top_p=0.9)
    seen = []
    real = generation._sample

    def spy(logits, temperature, top_k, top_p, noise=None):
        tok = real(logits, temperature, top_k, top_p, noise)
        seen.append((logits.clone(), tok))
        return tok
    monkeypatch.setattr(generation, "_sample", spy)
    a = port.generate(ids, seed=7, **kw)
    b = port.generate(ids, seed=7, **kw)
    c = port.generate(ids, seed=7, use_jit=True, **kw)
    d = port.generate(ids, seed=8, **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, d)
    assert len(seen) == 4 * N
    for logits, tok in seen:
        allowed = torch.isfinite(generation._filter_logits(logits, 0.8, 20,
                                                           0.9))
        assert allowed.gather(1, tok[:, None]).all()
        assert int(allowed.sum(1).min()) >= 1
