"""The port's Llama serving forward passes against the reference on the
CPU: chunked paged prefill, then a bucket-padded paged decode step, with
identical seeded weights (through models/convert.py), fp32, rtol/atol
1e-5, tied and untied heads — plus the functional pieces they are built
from (RMSNorm, swiglu, the masked attention composition, rotary)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit.api import functional_call
from paddle_tpu.models import llama as ref_llama
from paddle_tpu.nn import functional as ref_F
from paddle_tpu.nn.functional.flash_attention import _sdpa_ref
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.nn import functional as F

from _torch_parity import model_pair

TOL = dict(rtol=1e-5, atol=1e-5)


def _ref_program(model, method):
    """The reference model's paged forward as its engine runs it: a
    jitted functional call (its Pallas kernel in interpret mode needs
    the jit). Caches cross as lists of arrays and come back updated."""
    def program(state, kcs, vcs, *args):
        st = {k: Tensor(v) for k, v in state.items()}
        caches = [(Tensor(k), Tensor(v)) for k, v in zip(kcs, vcs)]
        with no_grad():
            logits, caches = functional_call(
                model, st, *(Tensor(a) for a in args[:1]), caches,
                *(Tensor(a) for a in args[1:]), method=method)
        return (logits._data, [c[0]._data for c in caches],
                [c[1]._data for c in caches])
    return jax.jit(program)


def _port_caches(num_layers, shape):
    return [(torch.zeros(shape), torch.zeros(shape))
            for _ in range(num_layers)]


@pytest.mark.parametrize("tied", [False, True])
def test_paged_prefill_then_decode_logits_match_reference(tied):
    ref, port = model_pair(seed=1, tie_word_embeddings=tied)
    cfg = port.cfg
    L, KVH = cfg.num_hidden_layers, cfg.num_key_value_heads
    D = cfg.hidden_size // cfg.num_attention_heads
    page, num_pages, S = 8, 12, 16
    shape = (num_pages, KVH, page, D)
    state = {k: v._data for k, v in ref.state_dict().items()}
    prefill = _ref_program(ref, "forward_paged_prefill")
    decode = _ref_program(ref, "forward_paged_decode")
    rk = [jnp.zeros(shape, jnp.float32) for _ in range(L)]
    rv = [jnp.zeros(shape, jnp.float32) for _ in range(L)]
    pc = _port_caches(L, shape)
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, cfg.vocab_size, 13)
    bt = np.array([4, 9, 0, 0], np.int32)   # non-contiguous pages

    # two prefill chunks: tokens [0, 9) then [9, 13), each padded to S
    for start, length in ((0, 9), (9, 4)):
        ids = np.zeros((1, S), np.int64)
        ids[0, :length] = prompt[start:start + length]
        r_logits, rk, rv = prefill(
            state, rk, rv, jnp.asarray(ids, jnp.int32), jnp.asarray(bt),
            jnp.int32(start), jnp.int32(length))
        with torch.inference_mode():
            p_logits, pc = port.forward_paged_prefill(
                torch.from_numpy(ids), pc, torch.from_numpy(bt), start,
                length)
        assert tuple(p_logits.shape) == (1, 1, cfg.vocab_size)
        np.testing.assert_allclose(p_logits.numpy(),
                                   np.asarray(r_logits), **TOL)

    # one decode step in a B=3 bucket: the live sequence, a second live
    # row with its own pages, and a seq_len-0 pad row
    for l in range(L):
        for side in (0, 1):
            fill = rng.randn(*shape[1:]).astype(np.float32)
            ref_side = rk if side == 0 else rv
            ref_side[l] = ref_side[l].at[7].set(fill)
            pc[l][side][7] = torch.from_numpy(fill)
    bt_d = np.array([[4, 9, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    sl = np.array([14, 6, 0], np.int32)
    ids = np.array([[prompt[-1]], [5], [0]], np.int64)
    r_logits, rk, rv = decode(state, rk, rv, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(bt_d), jnp.asarray(sl))
    with torch.inference_mode():
        p_logits, pc = port.forward_paged_decode(
            torch.from_numpy(ids), pc, torch.from_numpy(bt_d),
            torch.from_numpy(sl))
    np.testing.assert_allclose(p_logits.numpy()[:2],
                               np.asarray(r_logits)[:2], **TOL)
    assert np.all(np.isfinite(p_logits.numpy()))
    # the caches agree too (page 0, the pad page, excluded)
    for k, v, (pk, pv) in zip(rk, rv, pc):
        np.testing.assert_allclose(pk.numpy()[1:], np.asarray(k)[1:], **TOL)
        np.testing.assert_allclose(pv.numpy()[1:], np.asarray(v)[1:], **TOL)


def test_rms_norm_matches_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    want = ref_F.rms_norm(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(w)),
                          epsilon=1e-6)
    got = F.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)


def test_swiglu_matches_reference():
    rng = np.random.RandomState(3)
    x, y = rng.randn(2, 4, 32).astype(np.float32), \
        rng.randn(2, 4, 32).astype(np.float32)
    want = ref_F.swiglu(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y)))
    got = F.swiglu(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data), **TOL)


def test_masked_sdpa_matches_reference():
    """The prefill attention: explicit bottom-right-aligned mask
    kpos <= cache_len + i, never a top-left is_causal."""
    rng = np.random.RandomState(4)
    B, Sq, Sk, H, D = 1, 6, 20, 4, 64
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Sk, H, D).astype(np.float32)
    v = rng.randn(B, Sk, H, D).astype(np.float32)
    cache_len = 9
    mask = (np.arange(Sk)[None, :]
            <= cache_len + np.arange(Sq)[:, None])[None, None]
    want = _sdpa_ref(*(jnp.asarray(a) for a in (q, k, v, mask)))
    got = F.sdpa_ref(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rotary_and_rope_tables_match_reference():
    rng = np.random.RandomState(5)
    cos_r, sin_r = ref_llama._rope_cache(64, 40, 500000.0)
    cos_p, sin_p = port_llama._rope_cache(64, 40, 500000.0)
    np.testing.assert_allclose(cos_p.numpy(), np.asarray(cos_r), **TOL)
    np.testing.assert_allclose(sin_p.numpy(), np.asarray(sin_r), **TOL)
    x = rng.randn(2, 7, 3, 64).astype(np.float32)
    want = ref_llama.apply_rotary(jnp.asarray(x), cos_r[:7], sin_r[:7])
    got = port_llama.apply_rotary(torch.from_numpy(x), cos_p[:7], sin_p[:7])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xb = rng.randn(3, 1, 3, 64).astype(np.float32)
    pos = np.array([0, 17, 39])
    want = ref_llama.apply_rotary_positions(jnp.asarray(xb), cos_r[pos],
                                            sin_r[pos])
    got = port_llama.apply_rotary_positions(torch.from_numpy(xb),
                                            cos_p[pos], sin_p[pos])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convert_rejects_a_state_dict_that_does_not_fit():
    from paddle_tpu_torch.models.convert import from_jax_state_dict
    from _torch_parity import seeded_state
    cfg = port_llama.LlamaConfig(**dict(
        vocab_size=80, hidden_size=64, intermediate_size=96,
        num_hidden_layers=1, num_attention_heads=1, num_key_value_heads=1))
    state = seeded_state(cfg)
    assert set(from_jax_state_dict(state, cfg)) == set(state)
    bad = dict(state)
    bad["lm_head.weight"] = bad["lm_head.weight"].T
    with pytest.raises(ValueError, match="shape"):
        from_jax_state_dict(bad, cfg)
    bad = dict(state)
    del bad["model.norm.weight"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_state_dict(bad, cfg)
