"""The port's varlen (segment-id) and flashmask attention against the
reference on the CPU.

On CPU tensors the port's flash entries run their plain versions; they
are held against the reference's Pallas kernels in interpret mode
(`_fwd` / `_bwd_with_delta`), and the public entries
(`flash_attn_unpadded`, `flash_attn_varlen_qkvpacked`,
`flashmask_attention`) against the reference's, gradients against
`jax.grad` of the reference: fp32, atol/rtol 1e-5 (the two sum in
different orders). The public entries' reference runs its dense masked
composition (`sdp_kernel(enable_flash=False)`; an interpret-mode fwd +
bwd costs ~1.3 s a case), except the uneven-length unpadded case, which
takes the reference's Pallas path. Segment ids and positions are
compared bitwise. The CUDA kernels run only on the card:
tests/test_torch_cuda.py holds them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.kernels import flash_attention as ref_fa
from paddle_tpu.nn.functional.flash_attention import sdp_kernel
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import flash_attention as PF

TOL = dict(rtol=1e-5, atol=1e-5)


def _randn(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _t(x):
    return paddle.Tensor(jnp.asarray(x))


# ------------------------------------------------ segment ids, positions
@pytest.mark.parametrize("lens_q,lens_k,tail", [
    ([5, 7, 8], [5, 7, 8], 0), ([4, 6], [4, 8], 0), ([0, 9, 3, 0], [2, 9, 1, 4], 4)])
def test_segment_ids_and_positions_are_bitwise_the_references(
        monkeypatch, lens_q, lens_k, tail):
    """`_segment_ids_from_cu` (tokens past cu[-1] their own segment),
    `_positions_in_segments` and `flash_attn_unpadded`'s shifted query
    positions, captured where each entry hands them to its flash entry."""
    cq = np.cumsum([0] + lens_q).astype(np.int32)
    ck = np.cumsum([0] + lens_k).astype(np.int32)
    total_q, total_k = cq[-1] + tail, ck[-1] + tail
    np.testing.assert_array_equal(
        PF._segment_ids_from_cu(torch.from_numpy(cq), total_q).numpy(),
        np.asarray(RF._fa_mod._segment_ids_from_cu(jnp.asarray(cq),
                                                   total_q)))
    rng = np.random.RandomState(total_q)
    seg = np.sort(rng.randint(0, 5, (2, 40)), axis=1).astype(np.int32)
    np.testing.assert_array_equal(
        fa._positions_in_segments(torch.from_numpy(seg)).numpy(),
        np.asarray(ref_fa._positions_in_segments(jnp.asarray(seg))))

    # each entry's flash call hands back its segment ids and positions,
    # flattened into one row: [segq, segk, q positions, kv positions]
    def ref_spy(q, k, v, segq, segk, q_positions, kv_positions, **kw):
        return jnp.concatenate([segq[0], segk[0], q_positions[0],
                                kv_positions[0]])[None]

    def port_spy(q, k, v, segq, segk, q_positions, kv_positions, **kw):
        return torch.cat([segq[0], segk[0], q_positions[0],
                          kv_positions[0]])[None]
    monkeypatch.setattr(ref_fa, "flash_attention_varlen_bshd", ref_spy)
    monkeypatch.setattr(fa, "flash_attention_varlen_bshd", port_spy)
    # head dim 8 and totals padded to multiples of 8 pass check_supported
    pad_q, pad_k = -total_q % 8, -total_k % 8
    q = np.zeros((total_q + pad_q, 1, 8), np.float32)
    k = np.zeros((total_k + pad_k, 1, 8), np.float32)
    want = jax.jit(lambda *xs: RF.flash_attn_unpadded(
        *map(_t, xs), 9, 9, scale=0.5, causal=True)[0]._data)(
            q, k, k, cq, ck)
    got = F.flash_attn_unpadded(*map(torch.from_numpy, (q, k, k, cq, ck)),
                                9, 9, scale=0.5, causal=True)[0]
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- kernel entries
def _fm_cases(B, S):
    """The reference test's four `_fm_cases` (tests/test_flash_varlen_mask
    .py): a document mask (C 1), a causal band (C 2), non-causal C 2 and
    C 4, as (B, 1, S, C) bounds and causal."""
    doc = np.full((B, 1, S, 1), S, np.int32)
    doc[0, 0, :128, 0] = 128
    band = np.zeros((B, 1, S, 2), np.int32)
    band[..., 0] = np.minimum(np.arange(S) + 64, S)
    band[..., 1] = S
    nc2 = np.zeros((B, 1, S, 2), np.int32)
    nc2[..., 0] = np.minimum(np.arange(S) + 32, S)
    nc2[..., 1] = np.maximum(np.arange(S) - 32, 0)
    nc4 = np.zeros((B, 1, S, 4), np.int32)
    nc4[..., 0] = np.minimum(np.arange(S) + 16, S)
    nc4[..., 1] = np.minimum(np.arange(S) + 48, S)
    nc4[..., 2] = 0
    nc4[..., 3] = np.maximum(np.arange(S) - 48, 0)
    return {"doc": (doc, True), "band": (band, True), "nc2": (nc2, False),
            "nc4": (nc4, False)}


def _per_head_band(B, H, S):
    """Hm = H: a causal band of another width in each head."""
    idx = np.zeros((B, H, S, 2), np.int32)
    for h in range(H):
        idx[:, h, :, 0] = np.minimum(np.arange(S) + 16 + 40 * h, S)
        idx[:, h, :, 1] = S
    return idx, True


def _seg_rows(B, lens_q, lens_k, causal):
    """(segq, segk) (B, 2, S) int32 [id; position], the query positions
    shifted by each sequence's k_len - q_len; zeros without causal."""
    def rows(lens, shift):
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
        pos = np.concatenate([np.arange(n) + d for n, d in zip(lens, shift)])
        return np.stack([ids, pos * causal])
    shift = [b - a for a, b in zip(lens_q, lens_k)]
    return tuple(np.broadcast_to(rows(ls, sh), (B, 2, sum(ls)))
                 .astype(np.int32).copy()
                 for ls, sh in ((lens_q, shift), (lens_k, [0] * len(lens_k))))


# (the non-causal segment mode is held through flash_attn_unpadded below)
KERNEL_CASES = ["seg_causal", "doc", "band", "nc2", "nc4", "heads"]


def _case_masks(case, B, H):
    """A kernel case's masks as numpy arrays: (kw of the port's entries,
    Sq, Sk, causal) — segments with non-uniform q/k lengths (`seg`
    without causal), or the `_fm_cases` / per-head bounds as (B*Hm, C, S)."""
    if case.startswith("seg"):
        causal, lens_q, lens_k = case == "seg_causal", [24, 9, 31], [40, 5, 35]
        return (dict(seg=_seg_rows(B, lens_q, lens_k, causal)), sum(lens_q),
                sum(lens_k), causal)
    S = 256 if case != "heads" else 64
    idx, causal = (_per_head_band(B, H, S) if case == "heads"
                   else _fm_cases(B, S)[case])
    fm = np.ascontiguousarray(idx.transpose(0, 1, 3, 2)
                              .reshape(-1, idx.shape[3], S))
    return dict(fm=fm, fm_causal=causal), S, S, causal


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_kernel_entries_match_reference_interpret_kernels(case):
    """flash_fwd (out, lse), flash_dq and flash_dkv with segments (causal
    with non-uniform q/k lengths, some queries seeing no key) or flashmask
    bounds (the four `_fm_cases`, and per-head bounds) against the
    reference's `_fwd` and `_bwd_with_delta` in interpret mode."""
    B, H, D = 1, 2, 32
    rng = np.random.RandomState(KERNEL_CASES.index(case))
    masks, Sq, Sk, causal = _case_masks(case, B, H)
    kw = {k: tuple(map(torch.from_numpy, x)) if k == "seg" else
          torch.from_numpy(x) if k == "fm" else x for k, x in masks.items()}
    rkw = {k: tuple(map(jnp.asarray, x)) if k == "seg" else
           jnp.asarray(x) if k == "fm" else x for k, x in masks.items()}
    q, do = (_randn(rng, B * H, Sq, D) for _ in range(2))
    k, v = (_randn(rng, B * H, Sk, D) for _ in range(2))
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))

    want_o, want_lse = ref_fa._fwd(jq, jk, jv, scale, causal, Sq, Sk, H=H,
                                   **rkw)
    got_o, got_lse = fa.flash_fwd(tq, tk, tv, scale, causal, H=H, **kw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    # a row that sees no key has lse -1e30 in both
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)
    delta = fa.flash_delta(got_o, tdo)
    want = ref_fa._bwd_with_delta(scale, causal, Sq, Sk, jq, jk, jv,
                                  jnp.asarray(delta.numpy()), want_lse, jdo,
                                  H=H, **rkw)
    args = (tq, tk, tv, tdo, torch.from_numpy(np.array(want_lse)), delta,
            scale, causal)
    got = (fa.flash_dq(*args, H=H, **kw),) + fa.flash_dkv(*args, H=H, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", KERNEL_CASES + ["seg"])
def test_visits_plain_version_is_the_reference_block_predicate(case):
    """`flash_visits_ref`, the plain version of the masked kernels' count
    of visited tile pairs, is the reference's `_block_contributes` summed
    over every (q tile, k tile) pair and head, tiles cut at the sequence
    end (the kernels' in-range rows), at the kernels' two tiles."""
    B, H = 1, 2
    masks, Sq, Sk, causal = _case_masks(case, B, H)
    seg, fm = masks.get("seg"), masks.get("fm")
    for tile in (32, 64):
        want = 0
        for n in range(1 if seg is not None else fm.shape[0]):
            for qi in range(-(-Sq // tile)):
                for ki in range(-(-Sk // tile)):
                    qs = slice(qi * tile, (qi + 1) * tile)
                    ks = slice(ki * tile, (ki + 1) * tile)
                    blk = (dict(segq_blk=seg[0][0, 0, qs],
                                posq_blk=seg[0][0, 1, qs],
                                segk_blk=seg[1][0, 0, ks],
                                posk_blk=seg[1][0, 1, ks])
                           if seg is not None else
                           dict(segq_blk=None, segk_blk=None,
                                fm_blk=fm[n, :, ks],
                                fm_causal=masks["fm_causal"],
                                fm_cols=fm.shape[1]))
                    want += bool(ref_fa._block_contributes(
                        qi, ki, block_q=tile, block_k=tile,
                        q_offset=Sk - Sq, causal=causal, **blk))
        want *= H if seg is not None else B * H // fm.shape[0]
        kw = {k: tuple(map(torch.from_numpy, x)) if k == "seg" else
              torch.from_numpy(x) if k == "fm" else x
              for k, x in masks.items()}
        assert fa.flash_visits_ref(B * H, Sq, Sk, causal, H=H, tile=tile,
                                   **kw) == want, tile


# ------------------------------------------------------ public entries
def _grads_close(port_fn, ref_fn, arrays, dout, ref_flash=False):
    """The port's output and the gradients of <out, dout> against the
    reference's, with `jax.grad` on the reference side (its Pallas path
    only with `ref_flash`)."""
    def loss(*xs):
        out = ref_fn(*xs)
        return jnp.sum(out * jnp.asarray(dout)), out
    with sdp_kernel(enable_flash=ref_flash):
        want_g, want_o = jax.jit(jax.grad(
            loss, argnums=tuple(range(len(arrays))), has_aux=True))(
                *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out = port_fn(*ts)
    (out * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               **TOL)
    for t, w in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal,lens_q,lens_k", [
    (True, [40, 24, 32], [40, 24, 32]), (False, [40, 24, 32], [40, 24, 32]),
    (True, [20, 28, 16], [36, 28, 24])], ids=["causal", "noncausal",
                                              "nonuniform"])
def test_flash_attn_unpadded_matches_reference(causal, lens_q, lens_k):
    H, D = 2, 32
    rng = np.random.RandomState(sum(lens_k))
    cq = np.cumsum([0] + lens_q).astype(np.int32)
    ck = np.cumsum([0] + lens_k).astype(np.int32)
    q, do = (_randn(rng, cq[-1], H, D) for _ in range(2))
    k, v = (_randn(rng, ck[-1], H, D) for _ in range(2))
    scale = 1.0 / np.sqrt(D)
    mq, mk = max(lens_q), max(lens_k)

    def ref(a, b, c):
        return RF.flash_attn_unpadded(_t(a), _t(b), _t(c), _t(cq), _t(ck), mq,
                                      mk, scale=scale, causal=causal)[0]._data

    def port(a, b, c):
        return F.flash_attn_unpadded(a, b, c, torch.from_numpy(cq),
                                     torch.from_numpy(ck), mq, mk, scale,
                                     causal=causal)[0]
    _grads_close(port, ref, (q, k, v), do, ref_flash=lens_q != lens_k)


def test_flash_attn_varlen_qkvpacked_matches_reference():
    H, D = 2, 32
    rng = np.random.RandomState(1)
    cu = np.asarray([0, 24, 64, 96], np.int32)
    qkv, do = _randn(rng, 96, 3, H, D), _randn(rng, 96, H, D)

    def ref(x):
        return RF.flash_attn_varlen_qkvpacked(
            _t(x), _t(cu), _t(cu), 40, 40, 0.2, causal=True)[0]._data

    def port(x):
        return F.flash_attn_varlen_qkvpacked(
            x, torch.from_numpy(cu), torch.from_numpy(cu), 40, 40, 0.2,
            causal=True)[0]
    _grads_close(port, ref, (qkv,), do)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (False, (8, 20))],
                         ids=["bounds_causal", "bounds_noncausal",
                              "window_causal", "window_noncausal"])
def test_flashmask_attention_matches_reference(causal, window):
    """Bounds (per-head bands causal, a C 4 mask non-causal) or a sliding
    window through the public entry."""
    B, S, H, D = 1, 64, 2, 32
    rng = np.random.RandomState(2)
    q, k, v, do = (_randn(rng, B, S, H, D) for _ in range(4))
    if window is not None:
        idx = None
    elif causal:
        idx = _per_head_band(B, H, S)[0]
    else:
        idx = _fm_cases(B, S)["nc4"][0]

    def ref(a, b, c):
        return RF.flashmask_attention(
            _t(a), _t(b), _t(c), None if idx is None else _t(idx),
            causal=causal, window_size=window)._data

    def port(a, b, c):
        return F.flashmask_attention(
            a, b, c, None if idx is None else torch.from_numpy(idx),
            causal=causal, window_size=window)
    _grads_close(port, ref, (q, k, v), do)


# ------------------------------------------------------------- dispatch
def test_cpu_dispatch_takes_the_composition_where_the_reference_does(
        monkeypatch):
    """Shapes the reference's `check_supported` (or flashmask bound rule)
    refuses go to the masked composition on the CPU, as the reference's
    do, and agree with it; supported ones go to the flash entry. Dropout
    is refused. (On the card every call takes the kernels:
    tests/test_torch_cuda.py.)"""
    calls = []
    for name in ("flash_attention_varlen_bshd", "flashmask_attention_bshd"):
        real = getattr(fa, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(fa, name, spy)
    rng = np.random.RandomState(5)
    # varlen: 30 tokens (not a multiple of 8)
    cu = np.asarray([0, 11, 30], np.int32)
    q, k, v = (_randn(rng, 30, 2, 16) for _ in range(3))
    got = F.flash_attn_unpadded(*map(torch.from_numpy, (q, k, v, cu, cu)),
                                19, 19, 0.25, causal=True)[0]
    want = jax.jit(lambda *xs: RF.flash_attn_unpadded(
        *map(_t, xs), 19, 19, scale=0.25, causal=True)[0]._data)(
            q, k, v, cu, cu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # flashmask: head dim 12, and four bound columns under causal
    for D, C in ((12, 1), (16, 4)):
        q, k, v = (_randn(rng, 1, 32, 2, D) for _ in range(3))
        idx = np.minimum(np.arange(32)[:, None] + 5 + np.arange(C)[None] * 3,
                         32).astype(np.int32)[None, None]
        got = F.flashmask_attention(*map(torch.from_numpy, (q, k, v, idx)),
                                    causal=True)
        want = jax.jit(lambda *xs: RF.flashmask_attention(
            *map(_t, xs), causal=True)._data)(q, k, v, idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert calls == []
    # a supported shape takes the flash entry
    q, k, v = (_randn(rng, 1, 32, 2, 16) for _ in range(3))
    F.flashmask_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          window_size=4)
    assert calls == ["flashmask_attention_bshd"]
    with pytest.raises(NotImplementedError, match="dropout"):
        F.flash_attn_unpadded(*map(torch.from_numpy, (q[0], k[0], v[0])),
                              torch.tensor([0, 32]), torch.tensor([0, 32]),
                              32, 32, 0.25, dropout=0.1)


@pytest.mark.parametrize("Sk,Hm,C,causal", [(48, 1, 1, True), (32, 3, 1, True),
                                            (32, 1, 4, True),
                                            (32, 1, 1, False)])
def test_flashmask_entry_refuses_what_the_reference_refuses(Sk, Hm, C,
                                                            causal):
    q = np.zeros((1, 32, 2, 16), np.float32)
    k = np.zeros((1, Sk, 2, 16), np.float32)
    idx = np.zeros((1, Hm, Sk, C), np.int32)
    with pytest.raises(ValueError) as want:
        ref_fa.flashmask_attention_bshd(*map(jnp.asarray, (q, k, k, idx)),
                                        causal=causal)
    with pytest.raises(ValueError) as got:
        fa.flashmask_attention_bshd(*map(torch.from_numpy, (q, k, k, idx)),
                                    causal=causal)
    assert str(got.value) == str(want.value)
