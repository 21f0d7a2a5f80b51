"""The port's flash-attention module against the reference on the CPU.

On CPU tensors the port's entries run their plain versions
(`flash_fwd_ref`, `flash_dq_ref`, `flash_dkv_ref`); they are held
against the reference's Pallas kernels, which run in interpret mode off
the TPU: the forward (out and the fp32 lse) and the gradients of
`flash_attention_bshd` under autograd against `jax.grad` of the
reference's, fp32, atol/rtol 1e-5 (the two sum in different orders),
causal and not, Sq == Sk and Sq != Sk (bottom-right causal). The CUDA
kernels run only on the card: tests/test_torch_cuda.py holds them
against these plain versions there.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as ref_fa
from paddle_tpu.nn.functional.flash_attention import _sdpa_ref
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn.functional import flash_attention as F

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, Sq, Sk, H, D, causal)
CASES = [(2, 64, 64, 2, 32, True), (1, 32, 96, 2, 64, True),
         (1, 96, 48, 3, 16, False)]


def _inputs(B, Sq, Sk, H, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Sk, H, D).astype(np.float32),
            rng.randn(B, Sk, H, D).astype(np.float32),
            rng.randn(B, Sq, H, D).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_lse_and_gradients_match_reference(case):
    B, Sq, Sk, H, D, causal = case
    q, k, v, do = _inputs(B, Sq, Sk, H, D, seed=Sq + Sk + D)
    scale = 1.0 / np.sqrt(D)

    # forward, with the lse, on the (B*H, S, D) layout of the kernels
    def bhsd(x):
        return np.ascontiguousarray(
            x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], D))
    want_o, want_lse = ref_fa._fwd(
        *(jnp.asarray(bhsd(x)) for x in (q, k, v)), scale, causal, Sq, Sk)
    got_o, got_lse = fa.flash_fwd(*(torch.from_numpy(bhsd(x))
                                    for x in (q, k, v)), scale, causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)

    # gradients of <out, do> through the public (B, S, H, D) entry
    def ref_loss(a, b, c):
        return jnp.sum(ref_fa.flash_attention_bshd(a, b, c, causal=causal)
                       * jnp.asarray(do))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_bshd(tq, tk, tv, causal=causal)
    assert out.shape == (B, Sq, H, D)
    (out * torch.from_numpy(do)).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


def test_causal_is_bottom_right_aligned():
    """Sq < Sk: query i sees keys 0..i + Sk - Sq (the last query sees
    every key), never torch's top-left `is_causal`."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 8, 24, 1, 8, 0))
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    mask = torch.arange(24)[None, :] <= torch.arange(8)[:, None] + 16
    want = F.sdpa_ref(q, k, v, mask[None, None])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("q_shape,k_shape", [
    ((1, 64, 2, 64), (1, 64, 2, 64)), ((1, 64, 2, 264), (1, 64, 2, 264)),
    ((1, 64, 2, 12), (1, 64, 2, 12)), ((1, 12, 2, 64), (1, 64, 2, 64)),
    ((1, 64, 2, 64), (1, 20, 2, 64)), ((1, 1032, 1, 64), (1, 1032, 1, 64)),
    ((1, 1024, 1, 256), (1, 1160, 1, 256)),
    ((1, 1152, 1, 64), (1, 1152, 1, 64))])
def test_check_supported_refuses_what_the_reference_refuses(q_shape,
                                                            k_shape):
    def verdict(fn):
        try:
            fn(q_shape, k_shape, None)
        except ValueError:
            return False
        return True
    assert verdict(fa.check_supported) == verdict(ref_fa.check_supported)


def test_sdpa_dispatch(monkeypatch):
    """On the CPU: no mask, no dropout, supported shape -> the flash
    entry; a mask or an unsupported shape -> the plain composition,
    causal included; both agree with the reference's dispatch. Dropout
    is refused. (On the card every mask-free call takes the kernels:
    tests/test_torch_cuda.py.)"""
    q, k, v, _ = _inputs(1, 16, 16, 2, 64, seed=3)
    mask = np.tril(np.ones((16, 16), bool))[None, None] \
        & (np.arange(16) % 3 != 0)[None, None, None, :]
    calls = []
    real = fa.flash_attention_bshd

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(fa, "flash_attention_bshd", spy)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    got = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    assert calls == [{"causal": True}]
    want = _sdpa_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    got = F.scaled_dot_product_attention(tq, tk, tv,
                                         attn_mask=torch.from_numpy(mask))
    assert len(calls) == 1
    want = _sdpa_ref(jq, jk, jv, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    q12, k12, v12, _ = _inputs(1, 16, 24, 2, 12, seed=4)   # D 12: refused
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q12, k12, v12)), is_causal=True)
    assert len(calls) == 1
    want = _sdpa_ref(*(jnp.asarray(x) for x in (q12, k12, v12)),
                     causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    with pytest.raises(NotImplementedError, match="dropout"):
        F.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.1)


def test_ctypes_signatures_match_the_cuda_sources():
    """Each wrapper's ctypes argtypes mirror its C prototype parameter
    for parameter: a mismatch would pass garbage to a kernel, and only
    the card could show it."""
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    expect = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
              "float": ctypes.c_float, "longlong": ctypes.c_longlong}
    entries = [(fa.KERNEL_SOURCE, name, types)
               for name, types in fa.C_ARGTYPES.items()]
    assert set(fa.C_ARGTYPES) == {"flash_attention_fwd", "flash_attention_dq",
                                  "flash_attention_dkv"}
    entries.append((fo.KERNEL_SOURCE, "fused_adamw", fo.C_ARGTYPES))
    entries.append((fn.KERNEL_SOURCE, "rms_norm_rows", fn.C_ARGTYPES))
    for source, name, types in entries:
        src = (build.CSRC / source).read_text()
        proto = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src,
                          re.S).group(1)
        kinds = [expect[p.strip().replace("const ", "").rsplit(" ", 1)[0]
                        .replace(" ", "")] for p in proto.split(",")]
        assert kinds == types, name
        assert build.library_path(source).name.startswith(
            source.split(".")[0] + "-")
