"""Tests of the port that need the CUDA card (marker `cuda`); each skips
without one. This file imports torch and the port only — no JAX — so it
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.)
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.kernels import lora_matmul as lm
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import quant_matmul as qm
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.quant import weight_quantize
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (AdapterRegistry, DraftModelProposer,
                                      LoRAAdapter, ServingEngine)
from paddle_tpu_torch.serving.lora import runtime as lora_runtime

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100; see README)")
    # fp32 comparisons on the card: keep fp32 matmuls in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(B, KVH, G, D, page, max_pages, seq_lens, seed):
    rng = np.random.RandomState(seed)
    num_pages = B * max_pages + 3
    q = rng.randn(B, KVH * G, D).astype(np.float32)
    kc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    vc = rng.randn(num_pages, KVH, page, D).astype(np.float32)
    perm = rng.permutation(num_pages - 1) + 1
    bt = np.zeros((B, max_pages), np.int32)
    n = 0
    for b in range(B):
        for j in range(-(-int(seq_lens[b]) // page)):
            bt[b, j] = perm[n]
            n += 1
    return q, kc, vc, bt, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("G,D", [(4, 128), (1, 64), (2, 192), (8, 256)])
def test_kernel_matches_plain_version(card, G, D):
    """bf16 within 2e-2 (output rounding), fp32 within 1e-4 (summation
    order), a seq_len-0 pad row giving exact zeros."""
    seq_lens = [0, 1, 17, 128, 37, 64, 5, 99]
    args = _paged_case(B=8, KVH=4, G=G, D=D, page=16, max_pages=8,
                       seq_lens=seq_lens, seed=G * D)
    q, kc, vc, bt, sl = (torch.from_numpy(a).to(card) for a in args)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        before = pa.paged_attention_decode.launches
        got = pa.paged_attention_decode(q.to(dt), kc.to(dt), vc.to(dt),
                                        bt, sl)
        torch.cuda.synchronize()
        assert pa.paged_attention_decode.launches == before + 1
        want = pa.paged_attention_decode_ref(q.to(dt), kc.to(dt),
                                             vc.to(dt), bt, sl)
        assert got.dtype == dt
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (dt, err)
        assert torch.all(got[0] == 0)


def test_kernel_refuses_what_it_does_not_take(card):
    q, kc, vc, bt, sl = (torch.from_numpy(a).to(card) for a in _paged_case(
        B=2, KVH=2, G=2, D=64, page=8, max_pages=2, seq_lens=[3, 9],
        seed=0))
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_decode(q, kc, vc, bt.long(), sl)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_decode(q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), kc, vc, bt, sl)
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention_decode(q, kc.bfloat16(), vc.bfloat16(), bt, sl)
    with pytest.raises(ValueError, match="on"):
        pa.paged_attention_decode(q, kc, vc, bt.cpu(), sl)
    # a cache that does not start on 16 bytes: no bulk copy can read it
    odd = torch.empty(kc.numel() + 1, device=card)[1:].view(kc.shape)
    odd.copy_(kc)
    with pytest.raises(ValueError, match="aligned"):
        pa.paged_attention_decode(q, odd, vc, bt, sl)


def test_engine_on_card_matches_cpu_and_runs_the_kernel(card):
    """A tiny fp32 Llama served on the card gives the same greedy tokens
    as on the CPU, and every decode launch ran the kernel once per
    layer."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=128)
    kw = dict(num_pages=64, page_size=8, token_budget=48, batch_buckets=[8],
              prefill_buckets=[64], pages_buckets=[8])
    rng = np.random.RandomState(0)
    prompts = [(rng.randint(0, 128, int(n)).tolist(), 6)
               for n in rng.randint(3, 30, 6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device=dev,
                                 generator=torch.Generator(dev).manual_seed(1))
        if dev == "cuda":
            model.load_state_dict(cpu_state)
        else:
            cpu_state = {k: v.cuda() for k, v in model.state_dict().items()}
        eng = ServingEngine(model, device=dev, **kw)
        pa.paged_attention_decode.launches = 0
        rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
        eng.run()
        outs[dev] = [eng.requests[r].output_ids for r in rids]
        if dev == "cuda":
            assert (pa.paged_attention_decode.launches
                    == eng.metrics.counters["decode_launches"]
                    * cfg.num_hidden_layers > 0)
    assert outs["cuda"] == outs["cpu"]


# ------------------------------------------------------ quantized serving
def _int8_case(G, D, seed, device):
    """The paged case above with its K/V quantized per (slot, head)."""
    seq_lens = [0, 1, 17, 128, 37, 64, 5, 99]
    q, kc, vc, bt, sl = (torch.from_numpy(a).to(device) for a in _paged_case(
        B=8, KVH=4, G=G, D=D, page=16, max_pages=8, seq_lens=seq_lens,
        seed=seed))
    (k8, ks), (v8, vs) = pa.quantize_kv(kc), pa.quantize_kv(vc)
    return q, k8, v8, ks, vs, bt, sl


@pytest.mark.parametrize("G,D", [(4, 128), (1, 64), (2, 192), (8, 256)])
def test_int8_kernel_matches_plain_version(card, G, D):
    """The int8 variant against the plain version (which dequantizes
    first): bf16 q within 2e-2 (output rounding), fp32 within 1e-4
    (summation order and where the scale multiplies), the pad row exact
    zeros; counted in `.int8_launches` only."""
    q, k8, v8, ks, vs, bt, sl = _int8_case(G, D, G * D + 1, card)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        n0 = (pa.paged_attention_decode.launches,
              pa.paged_attention_decode.int8_launches)
        got = pa.paged_attention_decode(q.to(dt), k8, v8, bt, sl,
                                        k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert (pa.paged_attention_decode.launches,
                pa.paged_attention_decode.int8_launches) == \
            (n0[0], n0[1] + 1)
        want = pa.paged_attention_decode_ref(q.to(dt), k8, v8, bt, sl,
                                             k_scale=ks, v_scale=vs)
        assert got.dtype == dt
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (dt, err)
        assert torch.all(got[0] == 0)


@pytest.mark.parametrize("G,D,page,int8", [
    (4, 128, 16, False), (4, 128, 16, True), (1, 64, 8, False),
    (8, 256, 32, True), (2, 192, 16, False), (8, 64, 8, True)])
def test_split_kernel_edges_are_exact_and_deterministic(card, G, D, page,
                                                         int8):
    """Lengths at the edges of the kernel's split over a 64-page table,
    the batch short enough that rows split at the least split of m pages:
    one token, a seq_len-0 pad row, a length ending mid-page, on the first
    and second split boundary, one token past the first, the full table,
    a short row. bf16 within 2e-2 and fp32 within 1e-4 of the plain
    version, the pad row exact zeros, a second launch bitwise equal, the
    merge's ticket counters back at 0."""
    B, KVH, P = 8, 2, 64
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    chunks, m = pa.paged_decode_plan(KVH, page, sms)
    lens = [1, 0, 3 * page + 5, m * page, 2 * m * page, m * page + 1,
            P * page, 9]
    rows = pa.paged_decode_splits(lens, page, P, chunks, m)
    assert [pr for _, sp, pr in rows if sp > 1] == [m, (m + 2) // 2, m]
    q, kc, vc, bt, sl = (torch.from_numpy(a).to(card) for a in _paged_case(
        B=B, KVH=KVH, G=G, D=D, page=page, max_pages=P, seq_lens=lens,
        seed=G * D + page))
    extra = {}
    if int8:
        (kc, ks), (vc, vs) = pa.quantize_kv(kc), pa.quantize_kv(vc)
        extra = dict(k_scale=ks, v_scale=vs)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        k, v = (kc, vc) if int8 else (kc.to(dt), vc.to(dt))
        got = pa.paged_attention_decode(q.to(dt), k, v, bt, sl, **extra)
        again = pa.paged_attention_decode(q.to(dt), k, v, bt, sl, **extra)
        torch.cuda.synchronize()
        want = pa.paged_attention_decode_ref(q.to(dt), k, v, bt, sl, **extra)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (dt, err)
        assert torch.equal(got, again)
        assert torch.all(got[1] == 0)
    assert not pa._SCRATCH[q.device][2].any()


def test_long_context_splits_match_plain_version(card):
    """One request at 32768 tokens over the widest table (2048 pages),
    Llama-3-8B's widths: every split live, merged by one block."""
    lens = [32768 - 3]
    q, kc, vc, bt, sl = (torch.from_numpy(a).to(card) for a in _paged_case(
        B=1, KVH=8, G=4, D=128, page=16, max_pages=2048, seq_lens=lens,
        seed=3))
    q, kc, vc = q.bfloat16(), kc.bfloat16(), vc.bfloat16()
    got = pa.paged_attention_decode(q, kc, vc, bt, sl)
    torch.cuda.synchronize()
    want = pa.paged_attention_decode_ref(q, kc, vc, bt, sl)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert torch.equal(got, pa.paged_attention_decode(q, kc, vc, bt, sl))


# (M, K, N): decode rows at Llama-3-8B's gate and down (the latter split
# over K), a prefill chunk, the LM head's single prefill row, ragged
# edges in every dimension, and an odd K that defeats the vector loads
QMM_CASES = [(16, 4096, 14336), (16, 14336, 4096), (64, 4096, 1024),
             (1, 4096, 2048), (5, 200, 72), (17, 96, 130), (3, 37, 16)]
# the counter of each route's kernel
QMM_COUNTER = {"decode_sm90": "decode_launches", "sm90": "prefill_launches",
               "decode": "launches", "fp32": "launches", "mma": "launches"}
QMM_COUNTERS = ("launches", "prefill_launches", "decode_launches")


def _qmm_counts():
    return {c: getattr(qm.quant_matmul, c) for c in QMM_COUNTERS}


def _qmm_case(M, K, N, card, seed=None):
    """Seeded x (M, K) fp32 and a quantized (K, N) weight on the card."""
    rng = np.random.RandomState(M + K + N if seed is None else seed)
    w = torch.from_numpy((rng.randn(K, N) * 0.02).astype(np.float32))
    qw, s = (t.to(card) for t in weight_quantize(w))
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(card)
    return x, qw, s


# a rank's paged-decode shard under tensor parallelism at Llama-3-8B's
# widths: H 16 over KVH 4 (tp 2), H 8 over KVH 2 (tp 4)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kvh", [4, 2], ids=["tp2", "tp4"])
def test_paged_kernel_at_tensor_parallel_shards(card, kvh, int8):
    """bf16 and fp32 q within 2e-2 / 1e-4 of the plain version at the
    shard shapes (int8 caches with their scales too), pad row zero."""
    seq_lens = [0, 1, 17, 300, 1000, 129, 64, 777]
    q, kc, vc, bt, sl = (torch.from_numpy(a).to(card) for a in _paged_case(
        B=8, KVH=kvh, G=4, D=128, page=16, max_pages=64, seq_lens=seq_lens,
        seed=kvh))
    extra = {}
    if int8:
        (kc, ks), (vc, vs) = pa.quantize_kv(kc), pa.quantize_kv(vc)
        extra = dict(k_scale=ks, v_scale=vs)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        k, v = (kc, vc) if int8 else (kc.to(dt), vc.to(dt))
        got = pa.paged_attention_decode(q.to(dt), k, v, bt, sl, **extra)
        torch.cuda.synchronize()
        want = pa.paged_attention_decode_ref(q.to(dt), k, v, bt, sl, **extra)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (dt, err)
        assert torch.all(got[0] == 0)


# a rank's int8 matmul shards: the head split over the vocab at tp 2 and
# tp 4 (N 64128 and 32064: a half 256-column tile ends the decode
# stream), gate/up split over N and down over K at tp 2
@pytest.mark.parametrize("M", [1, 16, 512])
@pytest.mark.parametrize("kn", [(4096, 64128), (4096, 32064), (4096, 7168),
                                (7168, 4096)], ids=str)
def test_quant_matmul_at_tensor_parallel_shards(card, kn, M):
    """bf16 x within ||got - ref|| / ||ref|| <= 1e-2 of the plain
    version on the route's kernel (the decode stream up to 16 rows, the
    wgmma route above)."""
    K, N = kn
    route = qm.quant_matmul_route(M, K, N, torch.bfloat16)
    assert route == ("decode_sm90" if M <= 16 else "sm90")
    x, qw, s = _qmm_case(M, K, N, card)
    xb = x.bfloat16()
    n0 = _qmm_counts()
    got = qm.quant_matmul(xb, qw, s)
    torch.cuda.synchronize()
    counter = "decode_launches" if M <= 16 else "prefill_launches"
    assert _qmm_counts() == dict(n0, **{counter: n0[counter] + 1})
    _close_rel(got, qm.quant_matmul_ref(xb, qw, s), 1e-2)


def _card_ranks(fn, *args):
    """Run `fn(out_dir, *args)` in two rank processes of the port's
    spawn on the card(s); their pickled results in rank order."""
    import os
    import pickle
    import tempfile

    import _torch_tp_ranks
    from paddle_tpu_torch.distributed import spawn
    with tempfile.TemporaryDirectory() as tmp:
        spawn(getattr(_torch_tp_ranks, fn), args=(tmp, *args), nprocs=2,
              timeout=600)
        out = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def test_two_ranks_all_reduce_cuda_tensors(card):
    """Two rank processes sum CUDA tensors (fp32 and bf16) on the group
    init_parallel_env forms: gloo with both ranks on cuda:0 when there is
    one card, NCCL with a card each. The result stays on the card."""
    res = _card_ranks("card_all_reduce")
    want_backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    for r in res:
        assert r["backend"] == want_backend
        for dt in ("torch.float32", "torch.bfloat16"):
            dev, vals = r[dt]
            assert dev == "cuda"
            assert vals == [2.0 * i + 1 for i in range(8)]


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8", "wq": "int8"}],
                         ids=["fp32", "int8"])
def test_tensor_parallel_engine_on_the_card(card, kw):
    """A small fp32 model served at tp 2 by two rank processes on the
    card: both ranks' greedy tokens equal the tp 1 engine's, every decode
    launch through the paged kernel once a layer on each rank."""
    res = _card_ranks("card_engine", kw)
    for r in res:
        (t1, _, _), (t2, launches, decodes) = r[1], r[2]
        assert t2 == t1 == res[0][1][0]
        assert launches == decodes * 2 > 0


@pytest.mark.parametrize("case", QMM_CASES, ids=str)
def test_quant_matmul_matches_plain_version(card, case):
    """bf16 within ||got - ref|| / ||ref|| <= 1e-2 (the output's
    rounding), fp32 within 1e-4 of max |ref| (summation order); each
    launch counted by its route's kernel alone."""
    M, K, N = case
    x, qw, s = _qmm_case(M, K, N, card)
    for dt in (torch.bfloat16, torch.float32):
        n0 = _qmm_counts()
        got = qm.quant_matmul(x.to(dt), qw, s)
        torch.cuda.synchronize()
        counter = QMM_COUNTER[qm.quant_matmul_route(M, K, N, dt)]
        assert _qmm_counts() == dict(n0, **{counter: n0[counter] + 1})
        want = qm.quant_matmul_ref(x.to(dt), qw, s)
        assert got.dtype == dt and got.shape == (M, N)
        if dt == torch.float32:
            _close(got, want, 1e-4)
        else:
            _close_rel(got, want, 1e-2)


# (M, K, N) of the wgmma prefill route (csrc/quant_matmul_sm90.cu): each
# prefill tile height and K split the plan picks, Llama-3-8B's gate and
# down, and ragged edges — M not a multiple of 64, N a multiple of 16 but
# not of the 128-column tile, K not a multiple of the 64-deep stage
SM90_QMM_CASES = [(17, 4096, 1024), (64, 4096, 14336), (128, 14336, 4096),
                  (200, 4096, 1040), (72, 1000, 4112), (512, 4096, 14336),
                  (512, 14336, 4096)]


@pytest.mark.parametrize("case", SM90_QMM_CASES, ids=str)
def test_quant_matmul_prefill_route_matches_plain_version(card, case):
    """bf16 prefill rows take the wgmma kernel (one more
    `prefill_launches`) within ||got - ref|| / ||ref|| <= 1e-2; fp32 x at
    the same shape stays on quant_matmul.cu within 1e-4 of max |ref|."""
    M, K, N = case
    assert qm.quant_matmul_route(M, K, N, torch.bfloat16) == "sm90"
    rng = np.random.RandomState(M + K + N)
    w = torch.from_numpy((rng.randn(K, N) * 0.02).astype(np.float32))
    qw, s = (t.to(card) for t in weight_quantize(w))
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(card)
    n0 = qm.quant_matmul.prefill_launches
    got = qm.quant_matmul(x.bfloat16(), qw, s)
    torch.cuda.synchronize()
    assert qm.quant_matmul.prefill_launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _close_rel(got, qm.quant_matmul_ref(x.bfloat16(), qw, s), 1e-2)
    got = qm.quant_matmul(x, qw, s)
    assert qm.quant_matmul.prefill_launches == n0 + 1
    _close(got, qm.quant_matmul_ref(x, qw, s), 1e-4)


def test_quant_matmul_decode_and_unaddressable_shapes_keep_their_kernel(card):
    """bf16 M 16 (the decode bucket) takes the decode stream
    (quant_decode_sm90.cu); shapes TMA cannot address — N not a multiple
    of 16, K not of 8, an unaligned x — keep quant_matmul.cu at decode
    and prefill rows alike; same limits."""
    rng = np.random.RandomState(3)
    for M, K, N, shift, counter in (
            (16, 4096, 14336, 0, "decode_launches"),
            (16, 96, 130, 0, "launches"), (5, 100, 64, 0, "launches"),
            (16, 256, 128, 1, "launches"), (17, 96, 130, 0, "launches"),
            (40, 100, 64, 0, "launches"), (33, 256, 128, 1, "launches")):
        w = torch.from_numpy((rng.randn(K, N) * 0.02).astype(np.float32))
        qw, s = (t.to(card) for t in weight_quantize(w))
        xb = torch.from_numpy(rng.randn(M * K + shift).astype(np.float32)) \
            .to(card).bfloat16()
        x = xb[shift:].view(M, K)
        n0 = _qmm_counts()
        got = qm.quant_matmul(x, qw, s)
        torch.cuda.synchronize()
        assert _qmm_counts() == dict(n0, **{counter: n0[counter] + 1})
        _close_rel(got, qm.quant_matmul_ref(x, qw, s), 1e-2)


# (K, N) of the decode stream (csrc/quant_decode_sm90.cu): Llama-3-8B's
# gate/up, down and LM head, then ragged ones — K not a multiple of the
# 64-row unit, N a multiple of 16 but not of the 256-column tile, fewer
# units than SMs, a single unit
DECODE_QMM_KN = [(4096, 14336), (14336, 4096), (4096, 128256), (1000, 4112),
                 (200, 80), (136, 16), (8, 16)]


@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("kn", DECODE_QMM_KN, ids=str)
def test_quant_decode_stream_matches_plain_version(card, kn, M):
    """bf16 rows up to 16 that TMA can address take the decode stream:
    within ||got - ref|| / ||ref|| <= 1e-2 of quant_matmul_ref (the
    output's rounding), one `decode_launches` and no other counter."""
    K, N = kn
    assert qm.quant_matmul_route(M, K, N, torch.bfloat16) == "decode_sm90"
    x, qw, s = _qmm_case(M, K, N, card)
    xb = x.bfloat16()
    n0 = _qmm_counts()
    got = qm.quant_matmul(xb, qw, s)
    torch.cuda.synchronize()
    assert _qmm_counts() == dict(n0, decode_launches=n0["decode_launches"]
                                 + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _close_rel(got, qm.quant_matmul_ref(xb, qw, s), 1e-2)


def test_quant_decode_stream_is_deterministic(card):
    """No float atomics: repeated launches give bitwise equal outputs at
    shapes whose column tiles are merged from several CTAs' partials, and
    every ticket counter is back at 0 after each."""
    for M, K, N in ((16, 4096, 14336), (16, 14336, 4096), (1, 4096, 128256),
                    (13, 1000, 4112)):
        x, qw, s = _qmm_case(M, K, N, card)
        xb = x.bfloat16()
        first = qm.quant_matmul(xb, qw, s)
        for _ in range(3):
            again = qm.quant_matmul(xb, qw, s)
            torch.cuda.synchronize()
            assert torch.equal(first, again)
            assert not qm._DECODE_SCRATCH[first.device][1].any()


def test_quant_decode_stream_refuses_with_no_fallback(card, monkeypatch):
    """The C entry refuses what it does not take (cudaErrorInvalidValue =
    1): more than 16 rows, K not a multiple of 8, N not of 16, more CTAs
    than units, an unaligned base, no workspace. A refusal on the route
    raises in the wrapper, counts nothing and never reaches
    quant_matmul.cu or the plain version."""
    x, qw, s = _qmm_case(16, 256, 512, card)
    xb = x.bfloat16()
    out = torch.empty(16, 512, dtype=torch.bfloat16, device=card)
    ws, tickets = qm._decode_scratch(xb.device, 8, 2)
    entry = qm._decode_entry()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (xb, qw, s, out, ws, tickets)]
    for M, K, N, ctas in ((17, 256, 512, 8), (16, 252, 512, 8),
                          (16, 256, 520, 8), (16, 256, 512, 9),
                          (16, 256, 512, 0)):
        assert entry(*ptrs, M, K, N, ctas, stream) == 1
    assert entry(ptrs[0] + 8, *ptrs[1:], 16, 256, 512, 8, stream) == 1
    assert entry(*ptrs[:4], None, ptrs[5], 16, 256, 512, 8, stream) == 1
    assert entry(*ptrs, 16, 256, 512, 8, stream) == 0
    torch.cuda.synchronize()
    _close_rel(out, qm.quant_matmul_ref(xb, qw, s), 1e-2)

    def fell_back(*a, **k):
        raise AssertionError("fell back")
    monkeypatch.setattr(qm, "_decode_entry", lambda: lambda *a: 1)
    monkeypatch.setattr(qm, "_kernel_lib", fell_back)
    monkeypatch.setattr(qm, "quant_matmul_ref", fell_back)
    n0 = _qmm_counts()
    with pytest.raises(RuntimeError, match="quant_decode_sm90"):
        qm.quant_matmul(xb, qw, s)
    assert _qmm_counts() == n0


def test_bf16_quantized_engine_prefill_runs_the_wgmma_kernel(card):
    """A tiny bf16 Llama served with wq="int8" on the card through one
    64-token prefill bucket: every prefill chunk's MLP linears (3 per
    layer) take the wgmma route, the head's single row and the decode
    launches (8 rows) the decode stream, nothing quant_matmul.cu; every
    request completes."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=128,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=card, dtype=torch.bfloat16,
                             generator=torch.Generator(card).manual_seed(4))
    eng = ServingEngine(model, num_pages=64, page_size=8, token_budget=48,
                        batch_buckets=[8], prefill_buckets=[64],
                        pages_buckets=[8], wq="int8")
    rng = np.random.RandomState(1)
    prompts = [(rng.randint(0, 128, int(n)).tolist(), 6)
               for n in rng.randint(3, 30, 6)]
    qm.quant_matmul.launches = qm.quant_matmul.prefill_launches = 0
    qm.quant_matmul.decode_launches = 0
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
    eng.run()
    c = eng.metrics.counters
    assert c["prefill_chunks"] > 0
    assert qm.quant_matmul.prefill_launches == c["prefill_chunks"] * 6
    assert qm.quant_matmul.decode_launches == \
        c["decode_launches"] * 7 + c["prefill_chunks"]
    assert qm.quant_matmul.launches == 0
    assert [len(eng.requests[r].output_ids) for r in rids] == [6] * 6
    assert not c["requests_quarantined"]


def test_quantized_kernels_refuse_mismatches(card):
    q, k8, v8, ks, vs, bt, sl = _int8_case(2, 64, 0, card)
    with pytest.raises(ValueError, match="both"):
        pa.paged_attention_decode(q, k8, v8, bt, sl, k_scale=ks)
    with pytest.raises(ValueError, match="needs"):
        pa.paged_attention_decode(q, k8, v8, bt, sl)
    with pytest.raises(ValueError, match="not int8"):
        pa.paged_attention_decode(q, k8.float(), v8.float(), bt, sl,
                                  k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_attention_decode(q, k8, v8, bt, sl, k_scale=ks.double(),
                                  v_scale=vs)
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_attention_decode(q, k8, v8, bt, sl, k_scale=ks[1:],
                                  v_scale=vs)
    qw = torch.zeros(64, 32, dtype=torch.int8, device=card)
    s = torch.ones(32, device=card)
    # fp32 x (quant_matmul.cu) and bf16 decode rows (the decode stream)
    for x in (torch.zeros(4, 64, device=card),
              torch.zeros(16, 64, device=card, dtype=torch.bfloat16)):
        n0 = _qmm_counts()
        with pytest.raises(ValueError, match="int8"):
            qm.quant_matmul(x, qw.float(), s)
        with pytest.raises(ValueError, match="float32"):
            qm.quant_matmul(x, qw, s.bfloat16())
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            qm.quant_matmul(x.half(), qw, s)
        with pytest.raises(ValueError, match="fit"):
            qm.quant_matmul(x, qw[:32].contiguous(), s)
        with pytest.raises(ValueError, match="fit"):
            qm.quant_matmul(x, qw, s[:16])
        with pytest.raises(ValueError, match="on"):
            qm.quant_matmul(x, qw.cpu(), s)
        with pytest.raises(ValueError, match="contiguous"):
            qm.quant_matmul(x, qw.t().contiguous().t(), s)
        assert _qmm_counts() == n0


def test_quantized_engine_on_card_matches_cpu(card):
    """A tiny fp32 Llama served with wq="int8", kv_dtype="int8" on the
    card gives the CPU's greedy tokens; every decode launch ran the int8
    paged-decode kernel once per layer and every launch the int8 matmul
    kernel 3 times per layer plus once for the head."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=128)
    kw = dict(num_pages=64, page_size=8, token_budget=48, batch_buckets=[8],
              prefill_buckets=[64], pages_buckets=[8], wq="int8",
              kv_dtype="int8")
    rng = np.random.RandomState(1)
    prompts = [(rng.randint(0, 128, int(n)).tolist(), 6)
               for n in rng.randint(3, 30, 6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(4))
        model.to(dev)
        eng = ServingEngine(model, device=dev, **kw)
        assert eng.num_wq_layers == 7
        pa.paged_attention_decode.int8_launches = 0
        qm.quant_matmul.launches = 0
        rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
        eng.run()
        outs[dev] = [eng.requests[r].output_ids for r in rids]
        if dev == "cuda":
            c = eng.metrics.counters
            assert pa.paged_attention_decode.int8_launches == \
                c["decode_launches"] * cfg.num_hidden_layers > 0
            assert qm.quant_matmul.launches == \
                (c["decode_launches"] + c["prefill_chunks"]) * 7
    assert outs["cuda"] == outs["cpu"]


# ------------------------------------------------------------ LoRA
# (rows, tokens per entry, H, N, ranks, slots per bucket): one decode row
# at gate_proj; 13 rows over both buckets at k/v_proj; down_proj; a
# 512-token prefill chunk of one entry; 700 rows at ranks 1 and 64 with H
# and N not multiples of the H slice or of 8; rank 256 alone; ranks 16 and
# 256 together (16-row units) over 16-token entries; an odd H with N not a
# multiple of 4 (the unvectorised paths)
LORA_CASES = [(1, 1, 4096, 14336, (16,), 4), (13, 1, 4096, 1024, (8, 16), 4),
              (16, 1, 14336, 4096, (8, 16), 4),
              (512, 512, 4096, 14336, (8, 16), 4),
              (700, 1, 1100, 1032, (1, 64), 3), (37, 1, 4100, 1032, (256,), 3),
              (64, 16, 2048, 1024, (16, 256), 4),
              (8, 1, 1023, 130, (8,), 3)]


def _lora_case(rows, t, H, N, ranks, S, seed, device):
    """Seeded x, y, row slots and rank buckets (first slots 0, S, 2S, ...)
    whose slot 0 is zeros, as the registry's null adapter is (the
    reference's gathered composition reads it). The slots cover live
    slots, each bucket's slot 0 and ids naming no slot."""
    rng = np.random.RandomState(seed)
    B = rows // t
    x = torch.from_numpy(rng.randn(rows, H).astype(np.float32))
    y = torch.from_numpy(rng.randn(rows, N).astype(np.float32))
    buckets = []
    for bi, r in enumerate(ranks):
        a = torch.from_numpy((rng.randn(S, H, r) * 0.02).astype(np.float32))
        b = torch.from_numpy((rng.randn(S, r, N) * 0.02).astype(np.float32))
        a[0] = b[0] = 0.0
        buckets.append((a.to(device), b.to(device), bi * S))
    top = S * len(ranks)
    slots = rng.randint(-1, top + 2, B).astype(np.int32)
    slots[:min(B, 3)] = [1, 0, top][:min(B, 3)]
    return (x.to(device), y.to(device), torch.from_numpy(slots).to(device),
            lm.LoRABuckets(buckets))


def _null_rows(slots, t, buckets):
    live = torch.zeros_like(slots, dtype=torch.bool)
    for a, _, first in buckets.stacks:
        live |= (slots > first) & (slots < first + a.shape[0])
    return (~live).repeat_interleave(t)


@pytest.mark.parametrize("case", LORA_CASES, ids=str)
def test_lora_kernel_matches_plain_version(card, case):
    """The delta-only instantiation within 1e-5 of max |ref| (fp32
    products either way; only the summation order differs), bf16 and fp32
    x; the fused output, bf16 and fp32 y, bitwise y + delta.to(y.dtype) of
    the kernel's own delta, null rows exactly y + 0.0 and delta 0; one
    launch a call."""
    x, y, slots, buckets = _lora_case(*case, seed=sum(case[:4]), device=card)
    null = _null_rows(slots, case[1], buckets)
    for xdt in (torch.bfloat16, torch.float32):
        xx = x.to(xdt)
        before = lm.lora_apply.launches
        delta = lm.lora_apply(xx, None, slots, buckets)
        torch.cuda.synchronize()
        assert lm.lora_apply.launches == before + 1
        want = lm.lora_apply_ref(xx, None, slots, buckets)
        tol = 1e-5 * want.abs().max().item()
        assert (delta - want).abs().max().item() <= tol, xdt
        assert torch.all(delta[null] == 0)
        for ydt in (torch.bfloat16, torch.float32):
            yy = y.to(ydt)
            out = lm.lora_apply(xx, yy, slots, buckets)
            torch.cuda.synchronize()
            assert out.dtype == ydt
            assert torch.equal(out, yy + delta.to(ydt)), (xdt, ydt)
            assert torch.equal(out[null], yy[null] + 0.0)


def test_lora_kernel_rows_are_bitwise_independent(card):
    """A row keeps every bit, delta and output, when every other row's
    slot and every other slot's weights change (the grouping moves the
    row to another block, never changes its arithmetic); null rows stay
    exactly y + 0.0 when every bucket's slot 0 holds weights (no row
    reads them)."""
    x, y, slots, buckets = _lora_case(16, 1, 4096, 4096, (8, 16), 4, seed=3,
                                      device=card)
    slots = torch.full_like(slots, 6)
    xb, yb = x.bfloat16(), y.bfloat16()
    base = lm.lora_apply(xb, None, slots, buckets)
    base_out = lm.lora_apply(xb, yb, slots, buckets)
    slots2 = torch.tensor([6, 1, 3, 0, 9, 5, 2] + [6, 7] * 4 + [4],
                          dtype=torch.int32, device=card)
    stacks = [(a.clone(), b.clone(), f) for a, b, f in buckets.stacks]
    for a, b, _ in stacks:
        a[[1, 3]] *= 7.0
        b[[1, 3]] = -b[[1, 3]]
        a[0] = 1.0
        b[0] = 1.0
    stacks[1][0][3] *= 3.0           # global slot 7
    again = lm.lora_apply(xb, None, slots2, stacks)
    again_out = lm.lora_apply(xb, yb, slots2, stacks)
    keep = slots2 == 6
    assert torch.equal(base[keep], again[keep])
    assert torch.equal(base_out[keep], again_out[keep])
    null = (slots2 == 0) | (slots2 == 4) | (slots2 == 9)
    assert torch.all(again[null] == 0)
    assert torch.equal(again_out[null], yb[null] + 0.0)


def test_lora_kernel_repeat_launches_and_in_place_are_bitwise(card):
    """Repeat launches give the same bits; writing into y in place gives
    the out-of-place result."""
    x, y, slots, buckets = _lora_case(512, 512, 4096, 14336, (8, 16), 4,
                                      seed=5, device=card)
    xb, yb = x.bfloat16(), y.bfloat16()
    first = lm.lora_apply(xb, yb, slots, buckets)
    for _ in range(3):
        assert torch.equal(lm.lora_apply(xb, yb, slots, buckets), first)
    y2 = yb.clone()
    assert lm.lora_apply(xb, y2, slots, buckets, out=y2) is y2
    assert torch.equal(y2, first)


def test_lora_hook_under_autograd_keeps_y_graph(card):
    """With autograd on and y requiring grad, `apply_lora` adds the
    delta-only kernel's output out of place: the same bits as the fused
    kernel writing into y with autograd off, one launch, y itself left
    as it was, and y's gradient flowing through."""
    ranks, S = (8, 16), 4
    x, y, slots, buckets = _lora_case(13, 1, 4096, 1024, ranks, S, seed=7,
                                      device=card)
    layout = SimpleNamespace(dims={"k_proj": (4096, 1024)}, slots=S,
                             rank_buckets=ranks)
    stacks = {r: {"k_proj": (a, b)}
              for r, (a, b, _) in zip(ranks, buckets.stacks)}
    ctx = lora_runtime.LoRAContext(layout, stacks, slots)
    xb, yb = x.bfloat16()[:, None], y.bfloat16()[:, None]
    fused = yb.clone()
    with torch.no_grad(), lora_runtime.lora_scope(ctx):
        assert lora_runtime.apply_lora("k_proj", xb, fused) is not None
    assert not torch.equal(fused, yb)            # written in place
    yg = yb.clone().requires_grad_()
    before = lm.lora_apply.launches
    with torch.enable_grad(), lora_runtime.lora_scope(ctx):
        out = lora_runtime.apply_lora("k_proj", xb, yg)
    assert lm.lora_apply.launches == before + 1
    assert out.requires_grad and torch.equal(out.detach(), fused)
    assert torch.equal(yg.detach(), yb)
    out.float().sum().backward()
    assert torch.equal(yg.grad, torch.ones_like(yb))


def test_lora_kernel_refuses_what_it_does_not_take(card):
    x, y, slots, buckets = _lora_case(4, 1, 256, 64, (8,), 3, seed=1,
                                      device=card)
    a, b, _ = buckets.stacks[0]
    ids = slots
    with pytest.raises(ValueError, match="rank"):
        lm.lora_matmul(x, ids, torch.zeros(3, 256, 257, device=card),
                       torch.zeros(3, 257, 64, device=card))
    with pytest.raises(ValueError, match="int32"):
        lm.lora_matmul(x, ids.long(), a, b)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        lm.lora_matmul(x.half(), ids, a, b)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        lm.lora_apply(x, y.half(), slots, buckets)
    with pytest.raises(ValueError, match="on"):
        lm.lora_matmul(x, ids.cpu(), a, b)
    with pytest.raises(ValueError, match="on"):
        lm.lora_apply(x, y.cpu(), slots, buckets)
    with pytest.raises(ValueError, match="contiguous"):
        lm.lora_matmul(x, ids, a.transpose(1, 2).contiguous()
                       .transpose(1, 2), b)
    with pytest.raises(ValueError, match="contiguous"):
        lm.lora_apply(x.t().contiguous().t(), y, slots, buckets)
    with pytest.raises(ValueError, match="share"):
        lm.lora_matmul(x, ids, a, b[:2].contiguous())
    with pytest.raises(ValueError, match="disjoint"):
        lm.lora_apply(x, y, slots, [(a, b, 0), (a, b, 2)])


def test_lora_engine_on_card_matches_cpu(card):
    """A tiny fp32 Llama served with two rank buckets of adapters (one of
    them int8) on the card gives the CPU's greedy tokens; every launch
    ran the LoRA kernel once per module and layer."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=128)
    kw = dict(num_pages=64, page_size=8, token_budget=48, batch_buckets=[8],
              prefill_buckets=[64], pages_buckets=[8])
    rng = np.random.RandomState(2)
    names = ["l4", "h8", "q8", None]
    prompts = [(rng.randint(0, 128, int(n)).tolist(), 6, names[i % 4])
               for i, n in enumerate(rng.randint(3, 30, 8))]
    outs = {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(4))
        model.to(dev)
        reg = AdapterRegistry.for_model(model, rank_buckets=(4, 8), slots=3,
                                        device=dev)
        for name, rank, seed, quant in (("l4", 4, 1, None), ("h8", 8, 2, None),
                                        ("q8", 6, 3, "int8")):
            reg.load(LoRAAdapter.random(name, rank, reg.layout.dims,
                                        seed=seed, scale=0.2), quant=quant)
        eng = ServingEngine(model, device=dev, lora=reg, **kw)
        lm.lora_apply.launches = 0
        rids = [eng.add_request(p, max_new_tokens=m, adapter=a)
                for p, m, a in prompts]
        eng.run()
        outs[dev] = [eng.requests[r].output_ids for r in rids]
        if dev == "cuda":
            c = eng.metrics.counters
            want = (c["decode_launches"] + c["prefill_chunks"]) * 7 \
                * cfg.num_hidden_layers
            assert lm.lora_apply.launches == want > 0
            assert all(reg.refs_of(n) == 0 for n in names if n)
            reg.check_invariants()
    assert outs["cuda"] == outs["cpu"]


# ------------------------------------------------------ flash attention
# (B*H, Sq, Sk, D, causal): the training shape's head dim, a ragged
# length with Sq != Sk under the bottom-right causal mask, a head dim
# below the instantiated width, D 256 and D 200 (two column chunks, the
# second partial), a non-causal Sq > Sk, the smallest shape, and a
# causal Sq > Sk whose first rows see no key (zeros, as in the plain
# version)
FLASH_CASES = [(4, 256, 256, 128, True), (3, 72, 136, 64, True),
               (2, 64, 200, 40, False), (2, 96, 96, 256, True),
               (1, 64, 64, 200, False), (2, 136, 64, 128, False),
               (1, 8, 8, 8, True), (2, 40, 16, 8, True)]


def _flash_inputs(BH, Sq, Sk, D, seed, device):
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(BH, Sq, D).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(BH, Sk, D).astype(np.float32))
            for _ in range(2))
    return [t.to(device) for t in (q, k, v, do)]


def _close(got, want, tol):
    """max |got - want| within tol of the reference's largest value."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= tol * scale, (err, tol * scale)


def _close_rel(got, want, tol):
    """||got - want|| / ||want|| within tol: the bf16 measure, since a
    bound on the largest element would pass a kernel that drops a tile
    of every row's terms."""
    d = (got.float() - want.float()).norm()
    err = (d / want.float().norm().clamp_min(1e-30)).item()
    assert err <= tol and torch.isfinite(got).all(), (err, tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernels_match_plain_versions(card, case):
    """fwd (out, lse), dQ and dK/dV against the plain versions on the
    same inputs: fp32 within 1e-4 of the largest value (summation
    order); bf16 within a relative error of 1e-2 (output rounding, and
    P / dS rounded to bf16 before their products, give a few 1e-3); the
    lse, fp32 in both types, within 1e-4."""
    BH, Sq, Sk, D, causal = case
    q, k, v, do = _flash_inputs(BH, Sq, Sk, D, sum(case[:4]), card)
    scale = 1.0 / np.sqrt(D)
    for dt in (torch.float32, torch.bfloat16):
        def close(got, want):
            if dt == torch.float32:
                _close(got, want, 1e-4)
            else:
                _close_rel(got, want, 1e-2)
        qq, kk, vv, dd = (t.to(dt) for t in (q, k, v, do))
        n0 = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
        out, lse = fa.flash_fwd(qq, kk, vv, scale, causal)
        ref_out, ref_lse = fa.flash_fwd_ref(qq, kk, vv, scale, causal)
        close(out, ref_out)
        assert (lse - ref_lse).abs().max().item() <= 1e-4
        delta = fa.flash_delta(ref_out, dd)
        args = (qq, kk, vv, dd, ref_lse, delta, scale, causal)
        close(fa.flash_dq(*args), fa.flash_dq_ref(*args))
        for got, want in zip(fa.flash_dkv(*args), fa.flash_dkv_ref(*args)):
            assert got.dtype == dt
            close(got, want)
        torch.cuda.synchronize()
        assert (fa.flash_fwd.launches, fa.flash_dq.launches,
                fa.flash_dkv.launches) == tuple(n + 1 for n in n0)


# the forward's wgmma route (csrc/flash_fwd_sm90.cu) at every FLASH_CASE
# plus a causal multi-tile case at D 64 and a non-causal one with Sq < Sk
# and a ragged last key tile
SM90_FLASH_CASES = FLASH_CASES + [(2, 1024, 1024, 64, True),
                                  (2, 384, 512, 128, False)]


@pytest.mark.parametrize("case", SM90_FLASH_CASES, ids=str)
def test_flash_forward_route_matches_plain_version(card, case):
    """bf16 forwards at head_dim <= 128 take the wgmma kernel (one more
    `sm90_launches`), the rest flash_attention.cu; out within the bf16
    relative 1e-2, the fp32 lse within 1e-4."""
    BH, Sq, Sk, D, causal = case
    q, k, v, _ = _flash_inputs(BH, Sq, Sk, D, sum(case[:4]) + 1, card)
    qq, kk, vv = (t.bfloat16() for t in (q, k, v))
    scale = 1.0 / np.sqrt(D)
    sm90 = fa.flash_route(torch.bfloat16, D) == "sm90"
    assert sm90 == (D <= 128)
    n0, s0 = fa.flash_fwd.launches, fa.flash_fwd.sm90_launches
    out, lse = fa.flash_fwd(qq, kk, vv, scale, causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_fwd.sm90_launches) == \
        (n0 + 1, s0 + int(sm90))
    ref_out, ref_lse = fa.flash_fwd_ref(qq, kk, vv, scale, causal)
    _close_rel(out, ref_out, 1e-2)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


# the wgmma dQ and dK/dV (csrc/flash_bwd_sm90.cu) at the training shape
# and ragged ones: every FLASH_CASE the route takes (D <= 128), a causal
# Sq > Sk whose first 70 rows see no key, a causal multi-tile case at D 64,
# a non-causal Sq < Sk with a ragged last key tile, and Sq not a multiple
# of 4 (dK/dV's lse and delta rows padded for TMA)
SM90_BWD_CASES = [c for c in FLASH_CASES if c[3] <= 128] + [
    (32, 4096, 4096, 128, True), (2, 200, 130, 128, True),
    (2, 1024, 1024, 64, True), (2, 384, 520, 128, False),
    (2, 130, 130, 64, True), (3, 70, 198, 128, False)]


@pytest.mark.parametrize("case", SM90_BWD_CASES, ids=str)
def test_flash_bwd_route_matches_plain_version(card, case):
    """bf16 dQ and dK/dV at head_dim <= 128 take the wgmma kernels (one
    more `sm90_launches` each) and agree with the plain versions within
    the bf16 relative 1e-2; the dQ rows of queries that see no key are
    exactly zero."""
    BH, Sq, Sk, D, causal = case
    q, k, v, do = (t.bfloat16() for t in
                   _flash_inputs(BH, Sq, Sk, D, sum(case[:4]) + 2, card))
    scale = 1.0 / np.sqrt(D)
    assert fa.flash_route(torch.bfloat16, D) == "sm90"
    out, lse = fa.flash_fwd_ref(q, k, v, scale, causal)
    args = (q, k, v, do, lse, fa.flash_delta(out, do), scale, causal)
    n0 = [(f.launches, f.sm90_launches) for f in (fa.flash_dq, fa.flash_dkv)]
    dq = fa.flash_dq(*args)
    dk, dv = fa.flash_dkv(*args)
    torch.cuda.synchronize()
    assert [(f.launches, f.sm90_launches)
            for f in (fa.flash_dq, fa.flash_dkv)] == \
        [(a + 1, b + 1) for a, b in n0]
    _close_rel(dq, fa.flash_dq_ref(*args), 1e-2)
    for got, want in zip((dk, dv), fa.flash_dkv_ref(*args)):
        assert got.dtype == torch.bfloat16
        _close_rel(got, want, 1e-2)
    dead = lse < fa.NEG_INF / 2
    assert bool(dead.any()) == (causal and Sq > Sk)
    assert torch.all(dq[dead] == 0)


def test_flash_bwd_sm90_is_deterministic(card):
    """No atomics: two launches of each wgmma backward kernel on the same
    inputs give bitwise equal gradients."""
    q, k, v, do = (t.bfloat16() for t in
                   _flash_inputs(8, 1024, 1024, 128, 21, card))
    out, lse = fa.flash_fwd(q, k, v, 0.088, True)
    args = (q, k, v, do, lse, fa.flash_delta(out, do), 0.088, True)
    first = (fa.flash_dq(*args), *fa.flash_dkv(*args))
    again = (fa.flash_dq(*args), *fa.flash_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_bwd_sm90_refuses_with_no_fallback(card, monkeypatch):
    """The wgmma entries refuse what they do not take (cudaErrorInvalidValue
    = 1): head_dim > 128 or not a multiple of 8, B*H > 65535, an unaligned
    base; flash_attention.cu's refuse bf16 in the plain mode at head_dim
    <= 128, which the wgmma kernels own. A refusal on the route raises in
    the wrapper, counts nothing and never reaches flash_attention.cu or
    the plain version."""
    q, k, v, do = (t.bfloat16() for t in _flash_inputs(2, 64, 64, 64, 3,
                                                       card))
    lse = torch.zeros(2, 64, device=card)
    delta = torch.zeros(2, 64, device=card)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    for name, outs in (("flash_attention_dq_sm90", [dq.data_ptr()]),
                       ("flash_attention_dkv_sm90",
                        [dk.data_ptr(), dv.data_ptr()])):
        entry = fa._entry(name)
        for bad in ((2, 64, 64, 136), (2, 64, 64, 60), (70000, 64, 64, 64)):
            assert entry(*ins, *outs, *bad, 0.125, 1, stream) == 1
        assert entry(ins[0] + 8, *ins[1:], *outs, 2, 64, 64, 64, 0.125, 1,
                     stream) == 1
        # flash_attention.cu refuses the shapes the wgmma kernels own
        old = fa._entry(name.replace("_sm90", ""))
        tail = [None] * 7 + [2, 64, 64, 64, 1, 1, 0, 0.125, 1, 1, 0, 1,
                             stream]
        assert old(*ins, *outs, *tail) == 1
    torch.cuda.synchronize()

    def refusing(name):
        if not name.endswith("_sm90"):
            raise AssertionError(f"fell back to {name}")
        return lambda *a: 1
    monkeypatch.setattr(fa, "_entry", refusing)
    args = (q, k, v, do, lse, delta, 0.125, True)
    n0 = [(f.launches, f.sm90_launches) for f in (fa.flash_dq, fa.flash_dkv)]
    with pytest.raises(RuntimeError, match="flash_attention_dq_sm90"):
        fa.flash_dq(*args)
    with pytest.raises(RuntimeError, match="flash_attention_dkv_sm90"):
        fa.flash_dkv(*args)
    assert n0 == [(f.launches, f.sm90_launches)
                  for f in (fa.flash_dq, fa.flash_dkv)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_autograd_counts_sm90_backward(card, dtype):
    """FlashAttention's backward launches dQ and dK/dV once each: on the
    wgmma kernels in bf16 (`sm90_launches`), on flash_attention.cu in
    fp32; gradients against the CPU plain versions (bf16 relative 1e-2,
    fp32 1e-4 of the largest value)."""
    B, S, H, D = 2, 192, 4, 128
    rng = np.random.RandomState(9)
    base = [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]
    q, k, v = (torch.from_numpy(x).to(card, dtype).requires_grad_()
               for x in base)
    n0 = [(f.launches, f.sm90_launches) for f in (fa.flash_dq, fa.flash_dkv)]
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    sm90 = int(dtype == torch.bfloat16)
    assert [(f.launches, f.sm90_launches)
            for f in (fa.flash_dq, fa.flash_dkv)] == \
        [(a + 1, b + sm90) for a, b in n0]
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    ref = fa.flash_attention_bshd(qc, kc, vc, causal=True)
    ref.float().square().sum().backward()
    for g, r in zip((q.grad, k.grad, v.grad), (qc.grad, kc.grad, vc.grad)):
        if sm90:
            _close_rel(g.cpu(), r, 1e-2)
        else:
            _close(g.cpu(), r, 1e-4)


@pytest.mark.parametrize("B", [1, 2])
def test_flash_attention_autograd_runs_the_kernels(card, B):
    S, H, D = 128, 4, 64
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
               .to(card).requires_grad_() for _ in range(3))
    n0 = fa.flash_dkv.launches
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    out.square().sum().backward()
    assert fa.flash_dkv.launches == n0 + 1
    grads = [t.grad.clone() for t in (q, k, v)]
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    ref = fa.flash_attention_bshd(qc, kc, vc, causal=True)
    ref.square().sum().backward()
    _close(out.cpu(), ref, 1e-4)
    for g, t in zip(grads, (qc, kc, vc)):
        _close(g.cpu(), t.grad, 1e-4)


def test_flash_kernels_refuse_what_they_do_not_take(card):
    q, k, v, do = _flash_inputs(2, 64, 64, 64, 0, card)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_fwd(q.half(), k.half(), v.half(), 0.125, False)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     0.125, False)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_fwd(q, k.bfloat16(), v, 0.125, False)
    with pytest.raises(ValueError, match="fit"):
        fa.flash_fwd(q, k[:, :, :32].contiguous(), v, 0.125, False)
    bad = torch.zeros(2, 64, 264, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(bad, bad, bad, 0.125, False)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_dq(q, k, v, do, torch.zeros(2, 64, device=card,
                                             dtype=torch.float64),
                    torch.zeros(2, 64, device=card), 0.125, False)


def test_sdpa_sends_every_mask_free_call_to_the_kernels(card):
    """On the card the SDPA dispatch takes no TPU length rule: causal
    Sq 20 / Sk 1030 (the reference's `check_supported` refuses both)
    runs the flash kernels forward and backward and matches the plain
    composition; a head dim the kernels do not take raises, never a
    silent plain fallback."""
    from paddle_tpu_torch.nn.functional import flash_attention as F
    rng = np.random.RandomState(11)
    q = rng.randn(1, 20, 2, 64).astype(np.float32)
    k, v = (rng.randn(1, 1030, 2, 64).astype(np.float32) for _ in range(2))
    with pytest.raises(ValueError):
        fa.check_supported(q.shape, k.shape, None)
    tq, tk, tv = (torch.from_numpy(x).to(card).requires_grad_()
                  for x in (q, k, v))
    n0 = (fa.flash_fwd.launches, fa.flash_dkv.launches)
    out = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    out.square().sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_dkv.launches) == \
        (n0[0] + 1, n0[1] + 1)
    rq, rk, rv = (t.detach().clone().requires_grad_() for t in (tq, tk, tv))
    ref = F.sdpa_ref(rq, rk, rv, causal=True)
    ref.square().sum().backward()
    _close(out, ref, 1e-4)
    for t, r in zip((tq, tk, tv), (rq, rk, rv)):
        _close(t.grad, r.grad, 1e-4)
    bad = torch.zeros(1, 16, 2, 12, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        F.scaled_dot_product_attention(bad, bad, bad, is_causal=True)


# ------------------------------------------------------------ AdamW
@pytest.mark.parametrize("param_dtype,moment_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_adamw_kernel_bitwise_equals_plain_version(card, param_dtype,
                                                   moment_dtype):
    rows = 4 * 64 + 64
    rng = np.random.RandomState(3)

    def make(scale, dt):
        a = (scale * rng.randn(rows, fo.LANES)).astype(np.float32)
        return torch.from_numpy(a).to(card).to(dt)
    g = make(1e-2, param_dtype)
    w = make(1.0, torch.float32)
    m = make(1e-3, moment_dtype)
    v = make(1e-4, moment_dtype).abs()
    master = param_dtype != torch.float32
    sc = fo.adamw_scalars(3e-4, 0.9, 0.999, 1e-8, 0.01, 7, device=card)
    want = fo.fused_adamw_bucket_ref(g, w, m, v, sc,
                                     param_dtype if master else None)
    n0 = fo.fused_adamw_bucket.launches
    got = fo.fused_adamw_bucket(g, w.clone(), m.clone(), v.clone(), sc,
                                param_dtype if master else None)
    torch.cuda.synchronize()
    assert fo.fused_adamw_bucket.launches == n0 + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b), (a.float() - b.float()).abs().max()


def test_adamw_kernel_refuses_what_it_does_not_take(card):
    g = torch.zeros(64, fo.LANES, device=card)
    sc = fo.adamw_scalars(1e-3, 0.9, 0.999, 1e-8, 0.0, 1, device=card)
    with pytest.raises(ValueError, match="lane"):
        fo.fused_adamw_bucket(g[:, :64], g[:, :64], g[:, :64], g[:, :64],
                              sc)
    with pytest.raises(ValueError, match="not ported"):
        fo.fused_adamw_bucket(g.half(), g.clone(), g.clone(), g.clone(), sc,
                              torch.float16)
    with pytest.raises(ValueError, match="bucket"):
        fo.fused_adamw_bucket(g, g.clone(), g[:32].clone(), g.clone(), sc)
    with pytest.raises(ValueError, match="float32"):
        fo.fused_adamw_bucket(g, g.clone(), g.clone(), g.clone(),
                              sc.double())


# ------------------------------------------------------------ training
def test_train_steps_on_card_match_cpu_and_run_the_kernels(card):
    """Three fused-AdamW steps of a tiny fp32 Llama from the same weights
    on the card and on the CPU: losses within 1e-4 (summation order),
    and on the card every layer ran the flash kernels and every step the
    AdamW kernel."""
    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=2,
                      num_key_value_heads=1, max_position_embeddings=128)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 128, (2, 64)))
    labels = torch.from_numpy(rng.randint(0, 128, (2, 64)))
    labels[0, :5] = -100
    losses = {}
    for dev in ("cpu", "cuda"):
        model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(2))
        model.to(dev)
        opt = AdamW(1e-3, parameters=model.parameters(), fused=True)
        for fn in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv,
                   fo.fused_adamw_bucket):
            fn.launches = 0
        losses[dev] = []
        for _ in range(3):
            loss = model(ids.to(dev), labels=labels.to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[dev].append(loss.item())
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches, fo.fused_adamw_bucket.launches) \
        == (6, 6, 6, 3)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=1e-4)
    assert losses["cuda"][-1] < losses["cuda"][0]


# ----------------------------------------------- generate and recompute
# the forward at generate's shapes (B*H, Sq, Sk, D, causal): decode steps
# (one query row against a cache of 1 to 1025 keys, not causal, Sk not a
# multiple of the ring's 128-key tile) and a prefill against a cached
# prefix (Sq 13 < Sk 77, bottom-right causal)
DECODE_FLASH_CASES = [(8, 1, 1, 128, False), (8, 1, 7, 128, False),
                      (8, 1, 64, 128, False), (8, 1, 513, 128, False),
                      (8, 1, 1025, 128, False), (6, 1, 513, 64, False),
                      (4, 13, 77, 128, True)]


@pytest.mark.parametrize("case", DECODE_FLASH_CASES, ids=str)
def test_flash_forward_at_generate_shapes_matches_plain_version(card, case):
    """bf16 on the wgmma forward (one more `sm90_launches`, and one more
    `decode_launches` at Sq 1), fp32 on
    flash_attention.cu, each against the plain version with
    `flash_error`'s limits (bf16 relative 1e-2, fp32 1e-4 of the largest
    value, the lse 1e-4); rows past Sq are never written."""
    BH, Sq, Sk, D, causal = case
    q, k, v, _ = _flash_inputs(BH, Sq, Sk, D, sum(case[:4]) + 5, card)
    scale = 1.0 / np.sqrt(D)
    for dt in (torch.bfloat16, torch.float32):
        qq, kk, vv = (t.to(dt) for t in (q, k, v))
        s0 = fa.flash_fwd.sm90_launches
        d0 = fa.flash_fwd.decode_launches
        out, lse = fa.flash_fwd(qq, kk, vv, scale, causal)
        torch.cuda.synchronize()
        assert fa.flash_fwd.sm90_launches == s0 + int(dt == torch.bfloat16)
        assert fa.flash_fwd.decode_launches == \
            d0 + int(dt == torch.bfloat16 and Sq == 1)
        ref_out, ref_lse = fa.flash_fwd_ref(qq, kk, vv, scale, causal)
        if dt == torch.bfloat16:
            _close_rel(out, ref_out, 1e-2)
        else:
            _close(out, ref_out, 1e-4)
        assert (lse - ref_lse).abs().max().item() <= 1e-4
        assert out.shape == (BH, Sq, D) and lse.shape == (BH, Sq)


TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
            max_position_embeddings=128)


def _tiny_llama(dev):
    """The same seeded fp32 weights on either device (built on the CPU)."""
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             generator=torch.Generator().manual_seed(4))
    return model.to(dev)


def test_generate_on_card_matches_cpu(card):
    """A tiny fp32 Llama's greedy generate (eager and use_jit) gives the
    same tokens on the card as on the CPU; on the card every forward
    pass launched the flash forward once per layer."""
    rng = np.random.RandomState(6)
    ids = torch.from_numpy(rng.randint(0, 128, (2, 24)))
    outs = {}
    for dev in ("cpu", "cuda"):
        model = _tiny_llama(dev)
        n0 = fa.flash_fwd.launches
        outs[dev] = [model.generate(ids, max_new_tokens=8,
                                    use_jit=jit).cpu() for jit in (False,
                                                                   True)]
        if dev == "cuda":
            assert fa.flash_fwd.launches - n0 == 2 * 8 * 2
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(a, b)
    assert torch.equal(outs["cuda"][0], outs["cuda"][1])


def test_fused_adamw_lr_ratio_buckets_bitwise_equal_per_parameter(card):
    """Two lr_ratio groups: two fused buckets, two AdamW launches a step,
    and three clipped steps bitwise equal to the per-parameter fp32
    path."""
    rng = np.random.RandomState(8)
    shapes = [(96, 64), (64,), (64, 32), (32,)]
    init = [rng.randn(*sh).astype(np.float32) for sh in shapes]
    grads = [[rng.randn(*sh).astype(np.float32) for sh in shapes]
             for _ in range(3)]
    runs = {}
    for fused in (True, False):
        ps = [torch.nn.Parameter(torch.from_numpy(a).to(card)) for a in init]
        first = id(ps[0])
        opt = AdamW(1e-2, parameters=ps, fused=fused, weight_decay=0.05,
                    lr_ratio=lambda p: 0.5 if id(p) == first else 1.0,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        n0 = fo.fused_adamw_bucket.launches
        for step in grads:
            for p, g in zip(ps, step):
                p.grad = torch.from_numpy(g).to(card)
            opt.step()
        torch.cuda.synchronize()
        if fused:
            assert len(opt._fused_buckets) == 2
            assert fo.fused_adamw_bucket.launches - n0 == 6
        runs[fused] = ps
    for a, b in zip(runs[True], runs[False]):
        assert torch.equal(a, b), (a - b).abs().max()


def test_recompute_on_card_matches_no_recompute(card):
    """A tiny bf16 Llama (head_dim 64: the wgmma kernels) with
    recompute: each layer's flash forward runs twice (the replay), dQ
    and dK/dV once, all on the wgmma kernels; the loss and the
    gradients match the run without recompute (relative 1e-3)."""
    rng = np.random.RandomState(9)
    ids = torch.from_numpy(rng.randint(0, 128, (2, 96))).to(card)
    model = LlamaForCausalLM(LlamaConfig(**TINY), device=card,
                             dtype=torch.bfloat16,
                             generator=torch.Generator(card).manual_seed(4))
    res = {}
    for rc in (True, False):
        model.cfg.recompute = rc
        model.zero_grad(set_to_none=True)
        n0 = [(f.launches, f.sm90_launches)
              for f in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)]
        loss = model(ids, labels=ids)
        loss.backward()
        torch.cuda.synchronize()
        got = [(f.launches - a, f.sm90_launches - b) for f, (a, b) in
               zip((fa.flash_fwd, fa.flash_dq, fa.flash_dkv), n0)]
        assert got == [(2 * (1 + rc),) * 2, (2, 2), (2, 2)]
        res[rc] = (loss.float().item(),
                   [p.grad.float().clone() for p in model.parameters()])
    assert abs(res[True][0] - res[False][0]) <= 1e-3 * abs(res[False][0])
    for a, b in zip(res[True][1], res[False][1]):
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() <= 1e-3


# ----------------------------------------- varlen and flashmask attention
def _segments(B, lens_q, lens_k=None):
    """(segq, segk) (B, 2, S) int32 rows [segment id; position in it]
    for sequences of the given lengths, the same in every batch row; the
    query positions shifted by each sequence's k_len - q_len (as
    flash_attn_unpadded does)."""
    lens_k = lens_k or lens_q
    def rows(lens, shift):
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
        pos = np.concatenate([np.arange(n) + d for n, d in zip(lens, shift)])
        return np.stack([ids, pos]).astype(np.int32)
    shift = [kl - ql for ql, kl in zip(lens_q, lens_k)]
    return (np.broadcast_to(rows(lens_q, shift), (B, 2, sum(lens_q))).copy(),
            np.broadcast_to(rows(lens_k, [0] * len(lens_k)),
                            (B, 2, sum(lens_k))).copy())


def _fm_bounds(kind, B, Hm, S, seed):
    """(B*Hm, C, S) int32 flashmask bounds and fm_causal: a document mask
    (C 1), a causal band (C 2), non-causal C 2 and C 4, random widths."""
    rng = np.random.RandomState(seed)
    col = np.arange(S)
    if kind == "doc":
        ends = np.sort(rng.choice(np.arange(8, S), 3, replace=False))
        b = np.searchsorted(ends, col, side="right")
        start = np.append(ends, S)[b][None]
        return np.ascontiguousarray(np.broadcast_to(start, (B * Hm, 1, S)),
                                    dtype=np.int32), True
    w = rng.randint(8, 48, size=(B * Hm, 1, 1))
    if kind == "band":
        return np.concatenate([np.minimum(col + w, S),
                               np.full((B * Hm, 1, S), S)], 1) \
            .astype(np.int32), True
    if kind == "nc2":
        return np.concatenate([np.minimum(col + w, S),
                               np.maximum(col - w, 0) + 0 * w], 1) \
            .astype(np.int32), False
    return np.concatenate([np.minimum(col + w // 2, S),
                           np.minimum(col + w, S),
                           np.zeros((B * Hm, 1, S), int),
                           np.maximum(col - w, 0)], 1).astype(np.int32), False


# (name, B, H, Sq, Sk, D, causal, masks): varlen with ragged non-uniform
# q/k lengths (totals not tile multiples), documents that a 128-row block
# straddles (one shorter than 64 tokens: one warpgroup of a wgmma block
# computes a tile the other skips), flashmask in each bound count,
# per-head bounds (Hm = H)
MASKED_CASES = [
    ("varlen_causal", 1, 2, 100, 148, 64, True, ([40, 9, 51], [60, 25, 63])),
    ("varlen", 2, 2, 200, 200, 128, False, ([70, 64, 66],)),
    ("varlen_straddle", 1, 2, 300, 300, 128, True, ([40, 30, 100, 130],)),
    ("fm_doc", 2, 2, 200, 200, 64, True, ("doc", 1)),
    ("fm_band", 1, 2, 136, 136, 128, True, ("band", 1)),
    ("fm_nc2", 1, 2, 136, 136, 64, False, ("nc2", 1)),
    ("fm_nc4", 1, 3, 160, 160, 256, False, ("nc4", 1)),
    ("fm_heads", 2, 3, 130, 130, 64, True, ("band", 3)),
]


def _masked_case(case, device):
    name, B, H, Sq, Sk, D, causal, spec = case
    q, k, v, do = _flash_inputs(B * H, Sq, Sk, D, Sq + Sk + D, device)
    if name.startswith("varlen"):
        seg = tuple(torch.from_numpy(x).to(device)
                    for x in _segments(B, *spec))
        return q, k, v, do, dict(seg=seg, H=H), causal
    fm, fm_causal = _fm_bounds(spec[0], B, spec[1], Sk, D)
    return q, k, v, do, dict(fm=torch.from_numpy(fm).to(device),
                             fm_causal=fm_causal, H=H), causal


@pytest.mark.parametrize("case", MASKED_CASES, ids=lambda c: c[0])
def test_masked_flash_kernels_match_plain_versions(card, case):
    """The segment and flashmask modes of fwd (out, lse), dQ and dK/dV
    against the plain versions, with `flash_error`'s limits: fp32 within
    1e-4 of the largest value, bf16 a relative error of 1e-2, the lse
    1e-4. Each call launches its mode's kernel once and the plain mode's
    never; bf16 at head_dim <= 128 takes the wgmma kernels for the
    forward, dQ and dK/dV (`sm90_launches`), the rest flash_attention.cu.
    Each counts the tile pairs it visits as the plain predicate
    `flash_visits_ref` does."""
    q, k, v, do, kw, causal = _masked_case(case, card)
    kind = "varlen_launches" if "seg" in kw else "flashmask_launches"
    fns = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    scale = 1.0 / np.sqrt(q.shape[-1])
    for dt in (torch.float32, torch.bfloat16):
        def close(got, want):
            if dt == torch.float32:
                _close(got, want, 1e-4)
            else:
                _close_rel(got, want, 1e-2)
        n0 = [(getattr(f, kind), f.launches, f.sm90_launches) for f in fns]
        sm90 = int(dt == torch.bfloat16 and q.shape[-1] <= 128)
        assert [fa.flash_route(dt, q.shape[-1], "masked", kern)
                for kern in ("fwd", "dq", "dkv")] == \
            ["sm90" if sm90 else "mma"] * 3
        qq, kk, vv, dd = (t.to(dt) for t in (q, k, v, do))
        out, lse = fa.flash_fwd(qq, kk, vv, scale, causal, **kw)
        ref_out, ref_lse = fa.flash_fwd_ref(qq, kk, vv, scale, causal, **kw)
        close(out, ref_out)
        assert (lse - ref_lse).abs().max().item() <= 1e-4
        delta = fa.flash_delta(ref_out, dd)
        args = (qq, kk, vv, dd, ref_lse, delta, scale, causal)
        close(fa.flash_dq(*args, **kw), fa.flash_dq_ref(*args, **kw))
        for got, want in zip(fa.flash_dkv(*args, **kw),
                             fa.flash_dkv_ref(*args, **kw)):
            close(got, want)
        torch.cuda.synchronize()
        assert [(getattr(f, kind), f.launches, f.sm90_launches)
                for f in fns] == \
            [(a + 1, b, c + sm90) for a, b, c in n0]
        BH, Sq, D = q.shape
        tile = 32 if dt == torch.float32 and D > 128 else 64
        counts = torch.zeros(3, dtype=torch.int32, device=card)
        fa.flash_fwd(qq, kk, vv, scale, causal, visits=counts[0:1], **kw)
        fa.flash_dq(*args, visits=counts[1:2], **kw)
        fa.flash_dkv(*args, visits=counts[2:3], **kw)
        want = fa.flash_visits_ref(BH, Sq, k.shape[1], causal, tile=tile,
                                   **kw)
        assert counts.tolist() == [want] * 3


def test_rows_that_see_no_key_give_zeros(card):
    """A varlen query whose sequence has no key before it (causal, a
    negative shifted position) and a flashmask row masked everywhere:
    output and gradient rows are zeros and the lse about -1e30, as in
    the plain versions."""
    q, k, v, do = _flash_inputs(2, 64, 64, 64, 5, card)
    seg = (torch.tensor([[0] * 64, [-3] * 8 + list(range(56))],
                        dtype=torch.int32, device=card)[None],
           torch.tensor([[0] * 64, list(range(64))], dtype=torch.int32,
                        device=card)[None])
    fm = torch.zeros(1, 1, 64, dtype=torch.int32, device=card)
    fm[0, 0, 32:] = 64                  # rows 0-31 see nothing at all
    for kw in (dict(seg=seg, H=2), dict(fm=fm, fm_causal=True, H=2)):
        out, lse = fa.flash_fwd(q, k, v, 0.125, True, **kw)
        ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, 0.125, True, **kw)
        _close(out, ref_out, 1e-4)
        dead = ref_lse < -1e29
        assert dead.any() and torch.all(out[dead] == 0)
        assert torch.all(lse[dead] < -1e29)
        delta = fa.flash_delta(out, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta, 0.125, True, **kw)
        assert torch.all(dq[dead] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_backward_zero_rows_and_keys_are_exact(card, dtype):
    """Through either backward (bf16: the wgmma kernels; fp32:
    flash_attention.cu): a query that sees no key gets dQ rows of exact
    zeros, and a key that no query sees gets dK and dV rows of exact
    zeros — a varlen query before its sequence's keys, flashmask columns
    masked for every row."""
    q, k, v, do = (t.to(dtype) for t in _flash_inputs(2, 192, 192, 64, 8,
                                                      card))
    seg = (torch.tensor([[0] * 192, [-3] * 8 + list(range(184))],
                        dtype=torch.int32, device=card)[None],
           torch.tensor([[0] * 192, list(range(192))], dtype=torch.int32,
                        device=card)[None])
    fm = torch.full((1, 1, 192), 192, dtype=torch.int32, device=card)
    fm[0, 0, :40] = 0                   # keys 0-39: masked for every row
    fm[0, 0, 100:130] = 0               # keys 100-129 too, mid-block
    kinds = ("sm90_launches", "launches")
    for kw in (dict(seg=seg, H=2), dict(fm=fm, fm_causal=True, H=2)):
        out, lse = fa.flash_fwd_ref(q, k, v, 0.125, True, **kw)
        args = (q, k, v, do, lse, fa.flash_delta(out, do), 0.125, True)
        n0 = [getattr(fa.flash_dq, x) for x in kinds]
        dq = fa.flash_dq(*args, **kw)
        dk, dv = fa.flash_dkv(*args, **kw)
        torch.cuda.synchronize()
        assert [getattr(fa.flash_dq, x) for x in kinds] == \
            [n0[0] + int(dtype == torch.bfloat16), n0[1]]
        dead_q = lse < -1e29
        _, keep = fa._apply_masks(torch.zeros(2, 192, 192, device=card),
                                  True, **kw)
        dead_k = ~keep.expand(2, 192, 192).any(dim=1)
        assert dead_q.any() or dead_k.any()
        assert torch.all(dq[dead_q] == 0)
        assert torch.all(dk[dead_k] == 0) and torch.all(dv[dead_k] == 0)
        want = (fa.flash_dq_ref(*args, **kw),) + fa.flash_dkv_ref(*args,
                                                                 **kw)
        for got, ref in zip((dq, dk, dv), want):
            if dtype == torch.float32:
                _close(got, ref, 1e-4)
            else:
                _close_rel(got, ref, 1e-2)


def test_masked_flash_bwd_sm90_is_deterministic(card):
    """No atomics in the masked modes either: two launches of each wgmma
    backward kernel on the same varlen and flashmask inputs give bitwise
    equal gradients."""
    for case in (MASKED_CASES[2], MASKED_CASES[4]):
        q, k, v, do, kw, causal = _masked_case(case, card)
        q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
        out, lse = fa.flash_fwd(q, k, v, 0.09, causal, **kw)
        args = (q, k, v, do, lse, fa.flash_delta(out, do), 0.09, causal)
        first = (fa.flash_dq(*args, **kw), *fa.flash_dkv(*args, **kw))
        again = (fa.flash_dq(*args, **kw), *fa.flash_dkv(*args, **kw))
        torch.cuda.synchronize()
        for a, b in zip(first, again):
            assert torch.equal(a, b), case[0]


def test_masked_flash_bwd_sm90_refuses_with_no_fallback(card, monkeypatch):
    """The masked wgmma entries refuse (cudaErrorInvalidValue = 1) what
    they do not take — mode 0, a missing summary, flashmask with Sq != Sk,
    C 3 — and flash_attention.cu refuses the masked bf16 forward, dQ and
    dK/dV at head_dim <= 128. A refusal on the route raises, counts
    nothing and never reaches flash_attention.cu or the plain version."""
    q, k, v, do = (t.bfloat16() for t in _flash_inputs(2, 64, 64, 64, 3,
                                                       card))
    lse = torch.zeros(2, 64, device=card)
    delta = torch.zeros(2, 64, device=card)
    segq, segk = (torch.from_numpy(x).to(card) for x in _segments(1, [30, 34]))
    qsum, ksum, _ = fa.tile_summary((segq, segk))
    fm = torch.full((1, 1, 64), 64, dtype=torch.int32, device=card)
    fm2 = torch.full((1, 2, 64), 64, dtype=torch.int32, device=card)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    seg_ptrs = [segq.data_ptr(), segk.data_ptr(), qsum.data_ptr(),
                ksum.data_ptr(), None, None, None]
    fm_ptrs = [None] * 4 + [fm2.data_ptr(), None, None]
    for name, outs in (("flash_attention_dq_sm90_masked", [dq.data_ptr()]),
                       ("flash_attention_dkv_sm90_masked",
                        [dk.data_ptr(), dv.data_ptr()])):
        entry = fa._entry(name)

        def call(ptrs, Sk, C, mode, fm_causal=1):
            return entry(*ins, *outs, *ptrs, 2, 64, Sk, 64, 2, 1, C, 0.125,
                         1, fm_causal, mode, stream)
        assert call(seg_ptrs, 64, 0, 1) == 0
        assert call(seg_ptrs, 64, 0, 0) == 1
        assert call(seg_ptrs[:3] + [None] + seg_ptrs[4:], 64, 0, 1) == 1
        assert call(fm_ptrs, 64, 2, 2) == 0
        assert call(fm_ptrs, 64, 1, 2) == 1       # C 1 needs its summary
        assert call(fm_ptrs, 64, 3, 2) == 1
        assert call(fm_ptrs, 32, 2, 2) == 1
        old = fa._entry(name.replace("_sm90_masked", ""))
        assert old(*ins, *outs, *seg_ptrs, 2, 64, 64, 64, 2, 1, 0, 0.125, 1,
                   1, 1, 1, stream) == 1
    out = torch.empty_like(q)
    assert fa._entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *seg_ptrs, 2, 64, 64, 64, 2, 1, 0, 0.125, 1, 1, 1,
        1, stream) == 1
    torch.cuda.synchronize()

    def refusing(name):
        if not name.endswith("_sm90_masked"):
            raise AssertionError(f"fell back to {name}")
        return lambda *a: 1
    monkeypatch.setattr(fa, "_entry", refusing)
    args = (q, k, v, do, lse, delta, 0.125, True)
    counters = ("launches", "sm90_launches", "varlen_launches",
                "flashmask_launches")
    n0 = [[getattr(f, c) for c in counters] for f in (fa.flash_dq,
                                                       fa.flash_dkv)]
    for kw in (dict(seg=(segq, segk), H=2), dict(fm=fm, H=2)):
        with pytest.raises(RuntimeError, match="dq_sm90_masked"):
            fa.flash_dq(*args, **kw)
        with pytest.raises(RuntimeError, match="dkv_sm90_masked"):
            fa.flash_dkv(*args, **kw)
    assert n0 == [[getattr(f, c) for c in counters] for f in (fa.flash_dq,
                                                               fa.flash_dkv)]


# (name, B, H, Sq, Sk, D, causal, masks) of the wgmma masked forward on
# top of MASKED_CASES' bf16 ones: S 70 (one ring tile and a bit), C 4 and
# per-head C 2 at head_dim 128, one document spanning the row (every pair
# below the diagonal whole), causal C 1 documents at S 130 with short
# documents between long ones
SM90_FWD_MASKED_CASES = [
    ("varlen_s70", 1, 2, 70, 70, 128, True, ([30, 40],)),
    ("varlen_one_document", 1, 2, 320, 320, 128, True, ([320],)),
    ("fm_nc4_d128", 1, 2, 136, 136, 128, False, ("nc4", 1)),
    ("fm_doc_s130", 2, 2, 130, 130, 128, True, ("doc", 1)),
    ("fm_heads_d128", 1, 3, 200, 200, 128, True, ("band", 3)),
]


@pytest.mark.parametrize("case", [c for c in MASKED_CASES if c[5] <= 128]
                         + SM90_FWD_MASKED_CASES, ids=lambda c: c[0])
def test_masked_flash_fwd_sm90_matches_plain_version(card, case):
    """The wgmma masked forward (bf16, head_dim <= 128) against
    flash_fwd_ref: out within a relative error of 1e-2, the lse within
    1e-4 on rows that see a key, rows that see none exactly zero with the
    lse at -1e30. Each launch counts once in `sm90_launches` and its
    mode's counter and never in `launches`; `visits` equals
    `flash_visits_ref`; a second launch is bitwise equal."""
    q, k, v, _, kw, causal = _masked_case(case, card)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    kind = "varlen_launches" if "seg" in kw else "flashmask_launches"
    names = ("launches", "sm90_launches", kind)
    assert fa.flash_route(torch.bfloat16, q.shape[-1], "masked") == "sm90"
    n0 = [getattr(fa.flash_fwd, n) for n in names]
    visits = torch.zeros(1, dtype=torch.int32, device=card)
    out, lse = fa.flash_fwd(q, k, v, 0.1, causal, visits=visits, **kw)
    again = fa.flash_fwd(q, k, v, 0.1, causal, **kw)
    torch.cuda.synchronize()
    assert [getattr(fa.flash_fwd, n) for n in names] == \
        [n0[0], n0[1] + 2, n0[2] + 2]
    ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, 0.1, causal, **kw)
    _close_rel(out, ref_out, 1e-2)
    live = ref_lse > -1e29
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 1e-4
    assert torch.all(out[~live] == 0) and torch.all(lse[~live] < -1e29)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    BH, Sq, _ = q.shape
    assert visits.item() == fa.flash_visits_ref(BH, Sq, k.shape[1], causal,
                                                tile=64, **kw)


def test_masked_flash_fwd_sm90_rows_that_see_no_key(card):
    """bf16 through the wgmma forward: a varlen query before its
    sequence's keys and flashmask rows masked everywhere give output rows
    of exact zeros and the lse at -1e30, the rest as flash_fwd_ref."""
    q, k, v, _ = (t.bfloat16() for t in _flash_inputs(2, 192, 192, 64, 9,
                                                      card))
    seg = (torch.tensor([[0] * 192, [-3] * 8 + list(range(184))],
                        dtype=torch.int32, device=card)[None],
           torch.tensor([[0] * 192, list(range(192))], dtype=torch.int32,
                        device=card)[None])
    fm = torch.zeros(1, 1, 192, dtype=torch.int32, device=card)
    fm[0, 0, 40:] = 192                 # rows 0-39 see nothing at all
    for kw in (dict(seg=seg, H=2), dict(fm=fm, fm_causal=True, H=2)):
        n0 = fa.flash_fwd.sm90_launches
        out, lse = fa.flash_fwd(q, k, v, 0.125, True, **kw)
        torch.cuda.synchronize()
        assert fa.flash_fwd.sm90_launches == n0 + 1
        ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, 0.125, True, **kw)
        dead = ref_lse < -1e29
        assert dead.any() and torch.all(out[dead] == 0)
        assert torch.all(lse[dead] < -1e29)
        _close_rel(out, ref_out, 1e-2)
        assert (lse[~dead] - ref_lse[~dead]).abs().max().item() <= 1e-4


def test_masked_flash_fwd_sm90_refuses_with_no_fallback(card, monkeypatch):
    """The masked wgmma forward refuses (cudaErrorInvalidValue = 1) what
    it does not take — mode 0, a missing summary, flashmask with Sq !=
    Sk, C 3, D 136 — and a refusal on the route raises, counts nothing
    and never reaches flash_attention.cu or the plain version."""
    q, k, v, _ = (t.bfloat16() for t in _flash_inputs(2, 64, 64, 64, 3,
                                                      card))
    out, lse = torch.empty_like(q), torch.empty(2, 64, device=card)
    segq, segk = (torch.from_numpy(x).to(card) for x in _segments(1, [30, 34]))
    qsum, ksum, _ = fa.tile_summary((segq, segk))
    fm2 = torch.full((1, 2, 64), 64, dtype=torch.int32, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    entry = fa._entry("flash_attention_fwd_sm90_masked")
    seg_ptrs = [segq.data_ptr(), segk.data_ptr(), qsum.data_ptr(),
                ksum.data_ptr(), None, None, None]
    fm_ptrs = [None] * 4 + [fm2.data_ptr(), None, None]

    def call(ptrs, Sk, C, mode, D=64):
        return entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), *ptrs, 2, 64, Sk, D, 2,
                     1, C, 0.125, 1, 1, mode, stream)
    assert call(seg_ptrs, 64, 0, 1) == 0
    assert call(seg_ptrs, 64, 0, 0) == 1
    assert call(seg_ptrs[:3] + [None] + seg_ptrs[4:], 64, 0, 1) == 1
    assert call(fm_ptrs, 64, 2, 2) == 0
    assert call(fm_ptrs, 64, 1, 2) == 1       # C 1 needs its summary
    assert call(fm_ptrs, 64, 3, 2) == 1
    assert call(fm_ptrs, 32, 2, 2) == 1
    assert call(seg_ptrs, 64, 0, 1, D=136) == 1
    torch.cuda.synchronize()

    def refusing(name):
        if name != "flash_attention_fwd_sm90_masked":
            raise AssertionError(f"fell back to {name}")
        return lambda *a: 1
    monkeypatch.setattr(fa, "_entry", refusing)
    counters = ("launches", "sm90_launches", "varlen_launches",
                "flashmask_launches")
    n0 = [getattr(fa.flash_fwd, c) for c in counters]
    for kw in (dict(seg=(segq, segk), H=2), dict(fm=fm2, fm_causal=True,
                                                 H=2)):
        with pytest.raises(RuntimeError, match="fwd_sm90_masked"):
            fa.flash_fwd(q, k, v, 0.125, True, **kw)
    assert n0 == [getattr(fa.flash_fwd, c) for c in counters]


def test_varlen_and_flashmask_autograd_run_the_kernels(card):
    """flash_attn_unpadded, flash_attn_varlen_qkvpacked and
    flashmask_attention (bounds and window_size) forward and backward on
    the card: each launches its mode's fwd, dQ and dK/dV once, and
    matches the CPU (the plain versions) within 1e-4."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(3)
    H, D = 2, 64
    cu = torch.tensor([0, 37, 100, 130], dtype=torch.int32)
    x = rng.randn(130, 3, H, D).astype(np.float32)
    xb = rng.randn(2, 96, H, D).astype(np.float32)
    bounds = torch.from_numpy(_fm_bounds("doc", 2, 1, 96, 1)[0]
                              .reshape(2, 1, 1, 96).transpose(0, 1, 3, 2)
                              .copy())
    calls = {
        "unpadded": lambda t: F.flash_attn_unpadded(
            t[:, 0], t[:, 1], t[:, 2], cu.to(t.device), cu.to(t.device), 63,
            63, 0.125, causal=True)[0],
        "qkvpacked": lambda t: F.flash_attn_varlen_qkvpacked(
            t, cu.to(t.device), cu.to(t.device), 63, 63, 0.125,
            causal=False)[0],
        "bounds": lambda t: F.flashmask_attention(
            t, t * 0.5, t * 2.0, bounds.to(t.device), causal=True),
        "window": lambda t: F.flashmask_attention(
            t, t * 0.5, t * 2.0, window_size=(7, 11), causal=False),
    }
    for name, fn in calls.items():
        data = x if name in ("unpadded", "qkvpacked") else xb
        kind = "varlen_launches" if name in ("unpadded", "qkvpacked") \
            else "flashmask_launches"
        n0 = [getattr(f, kind) for f in (fa.flash_fwd, fa.flash_dq,
                                         fa.flash_dkv)]
        res = {}
        for dev in ("cpu", card):
            t = torch.from_numpy(data).to(dev).requires_grad_()
            out = fn(t)
            out.square().sum().backward()
            res[str(dev)] = (out.detach().cpu(), t.grad.cpu())
        assert [getattr(f, kind) for f in (fa.flash_fwd, fa.flash_dq,
                                           fa.flash_dkv)] == \
            [n + 1 for n in n0], name
        for got, want in zip(res[str(card)], res["cpu"]):
            _close(got, want, 1e-4)


def test_document_isolation_is_bitwise(card):
    """Changing one document's q/k/v leaves every other document's output
    rows and gradient rows bitwise unchanged, through the varlen and the
    flashmask (causal document mask) entries, bf16."""
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(4)
    lens = [70, 129, 64, 93]
    S, H, D = sum(lens), 4, 128
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32, device=card)
    ends = np.repeat(np.cumsum(lens), lens).astype(np.int32)
    bounds = torch.from_numpy(ends).to(card).view(1, 1, S, 1)
    base = torch.from_numpy(rng.randn(S, 3, H, D).astype(np.float32)) \
        .to(card).bfloat16()
    do = torch.from_numpy(rng.randn(S, H, D).astype(np.float32)) \
        .to(card).bfloat16()
    lo, hi = lens[0], lens[0] + lens[1]          # document 1 changes
    other = torch.ones(S, dtype=torch.bool, device=card)
    other[lo:hi] = False
    entries = {
        "varlen": lambda t: F.flash_attn_unpadded(
            t[:, 0], t[:, 1], t[:, 2], cu, cu, 129, 129, 0.1,
            causal=True)[0],
        "flashmask": lambda t: F.flashmask_attention(
            t[None, :, 0], t[None, :, 1], t[None, :, 2], bounds,
            causal=True)[0]}
    for name, fn in entries.items():
        res = []
        for change in (False, True):
            x = base.clone()
            if change:
                x[lo:hi] = x[lo:hi] * -1.5 + 0.25
            x.requires_grad_()
            out = fn(x)
            (out.float() * do.float()).sum().backward()
            res.append((out.detach(), x.grad))
        (o0, g0), (o1, g1) = res
        assert torch.equal(o0[other], o1[other]), name
        assert torch.equal(g0[other], g1[other]), name
        assert not torch.equal(o0[~other], o1[~other]), name


def test_masked_kernels_refuse_what_they_do_not_take(card):
    q, k, v, do = _flash_inputs(4, 64, 64, 64, 0, card)
    segq, segk = (torch.from_numpy(x).to(card) for x in _segments(2, [30, 34]))
    with pytest.raises(ValueError, match="int32"):
        fa.flash_fwd(q, k, v, 0.125, True, seg=(segq.long(), segk), H=2)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_fwd(q, k, v, 0.125, True, seg=(segq, segk), H=3)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_fwd(q, k, v, 0.125, True, seg=(segq[:, :, :60], segk), H=2)
    fm = torch.full((2, 1, 64), 64, dtype=torch.int32, device=card)
    # the C entry's own refusals: C 1 without causal bounds, Sq != Sk
    with pytest.raises(RuntimeError, match="refused"):
        fa.flash_fwd(q, k, v, 0.125, False, fm=fm, fm_causal=False, H=2)
    with pytest.raises(RuntimeError, match="refused"):
        fa.flash_fwd(q, k[:, :32].contiguous(), v[:, :32].contiguous(),
                     0.125, True, fm=fm[..., :32].contiguous(), H=2)
    with pytest.raises(ValueError, match="visits"):
        fa.flash_fwd(q, k, v, 0.125, True, fm=fm, H=2,
                     visits=torch.zeros(1, device=card))
    with pytest.raises(ValueError, match="Hm"):
        fa.flash_fwd(q, k, v, 0.125, True, fm=fm[:1].expand(3, 1, 64)
                     .contiguous(), H=2)
    with pytest.raises(ValueError, match="do not combine"):
        fa.flash_fwd(q, k, v, 0.125, True, seg=(segq, segk), fm=fm, H=2)
    bad = torch.zeros(1, 64, 2, 64, device=card)
    with pytest.raises(ValueError, match="heads dim"):
        fa.flashmask_attention_bshd(bad, bad, bad, torch.zeros(
            1, 3, 64, 1, dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="bound columns"):
        fa.flashmask_attention_bshd(bad, bad, bad, torch.zeros(
            1, 1, 64, 4, dtype=torch.int32, device=card), causal=True)
    from paddle_tpu_torch.nn import functional as F
    with pytest.raises(NotImplementedError, match="dropout"):
        F.flashmask_attention(bad, bad, bad, window_size=4, dropout=0.1)


# ------------------------------------------------------- RMSNorm rows
@pytest.mark.parametrize("R,H", [(64, 4096), (16, 4096), (7, 1100),
                                 (3, 100)])
def test_rms_norm_rows_kernel_matches_plain_version(card, R, H):
    """bf16 within one bf16 ulp of each reference element (the fp32
    pre-rounding values differ by summation order and rsqrtf), fp32
    within 1e-5 relative; with and without the residual, fp32 and bf16
    weights."""
    from paddle_tpu_torch.kernels import fused_norm as fn
    rng = np.random.RandomState(R + H)
    x, res = (torch.from_numpy(rng.randn(R, H).astype(np.float32) * 3)
              .to(card) for _ in range(2))
    w = torch.from_numpy(rng.randn(H).astype(np.float32)).to(card)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        for wt in (torch.float32, dt):
            for r in (None, res.to(dt)):
                n0 = fn.rms_norm_rows.launches
                got = fn.rms_norm_rows(x.to(dt), w.to(wt), r, eps=1e-6)
                want = fn.rms_norm_rows_ref(x.to(dt), w.to(wt), r, eps=1e-6)
                torch.cuda.synchronize()
                assert fn.rms_norm_rows.launches == n0 + 1
                assert got.dtype == dt and got.shape == (R, H)
                d = (got.float() - want.float()).abs()
                assert torch.all(d <= tol * want.float().abs() + 1e-6), \
                    (dt, wt, r is None, d.max().item())


def test_rms_norm_rows_refuses_what_it_does_not_take(card):
    from paddle_tpu_torch.kernels import fused_norm as fn
    x = torch.randn(4, 256, device=card)
    w = torch.randn(256, device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        fn.rms_norm_rows(x.clone().requires_grad_(), w)
    with pytest.raises(ValueError, match="2-D"):
        fn.rms_norm_rows(x[None], w)
    with pytest.raises(ValueError, match="residual"):
        fn.rms_norm_rows(x, w, x.bfloat16())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fn.rms_norm_rows(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        fn.rms_norm_rows(x.t().contiguous().t(), w)
    with torch.no_grad():
        fn.rms_norm_rows(x.clone().requires_grad_(), w)


# ------------------------------------- multi-step decode, spec, snapshot
SERVE_KW = dict(num_pages=64, page_size=8, token_budget=64,
                batch_buckets=[4], prefill_buckets=[64], pages_buckets=[8])


def _tiny_bf16(dev):
    """TINY in bf16 (rope tables stay fp32), seeded on the CPU."""
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(4))
    return model.to(dev)


def _serve_prompts(n=4, new=10, seed=12):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 128, int(k)).tolist(), new)
            for k in rng.randint(5, 17, n)]


def _serve(eng, prompts):
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_multi_step_launch_has_no_host_sync_and_equals_k1(card, kv_dtype,
                                                         monkeypatch):
    """bf16, K=4: each launch runs under set_sync_debug_mode("error")
    (nothing inside the K steps waits on the card), the paged-decode
    kernel runs once per layer per step, and the tokens equal K=1's
    (all rows admitted together, so each step's batch is K=1's)."""
    model = _tiny_bf16(card)
    prompts = _serve_prompts()
    k1 = _serve(ServingEngine(model, device=card, kv_dtype=kv_dtype,
                              **SERVE_KW), prompts)
    inner = type(model).forward_paged_decode_multi

    def no_sync(self, *a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(type(model), "forward_paged_decode_multi", no_sync)
    eng = ServingEngine(model, device=card, kv_dtype=kv_dtype,
                        decode_steps=4, **SERVE_KW)
    counter = "int8_launches" if kv_dtype else "launches"
    n0 = getattr(pa.paged_attention_decode, counter)
    k4 = _serve(eng, prompts)
    c = eng.metrics.counters
    assert getattr(pa.paged_attention_decode, counter) - n0 == \
        c["decode_launch_steps"] * TINY["num_hidden_layers"] > 0
    assert c["decode_launches"] < c["decode_launch_steps"]
    assert k4 == k1
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0


def test_lora_with_decode_steps_4_on_card(card):
    """Multi-LoRA at K=4 on the card: every request completes, the LoRA
    kernel ran once per module and layer per step and chunk."""
    model = _tiny_llama(card)
    reg = AdapterRegistry.for_model(model, rank_buckets=(4, 8), slots=3,
                                    device=card)
    for name, rank, seed in (("l4", 4, 1), ("h8", 8, 2)):
        reg.load(LoRAAdapter.random(name, rank, reg.layout.dims, seed=seed,
                                    scale=0.2))
    eng = ServingEngine(model, device=card, lora=reg, decode_steps=4,
                        **SERVE_KW)
    tags = ["l4", "h8", None, "l4"]
    n0 = lm.lora_apply.launches
    rids = [eng.add_request(p, max_new_tokens=m, adapter=a)
            for (p, m), a in zip(_serve_prompts(), tags)]
    out = eng.run()
    assert [len(out[r]) for r in rids] == [10] * 4
    c = eng.metrics.counters
    assert lm.lora_apply.launches - n0 == (
        c["decode_launch_steps"] + c["prefill_chunks"]) * 7 \
        * TINY["num_hidden_layers"] > 0
    assert all(reg.refs_of(n) == 0 for n in ("l4", "h8"))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cache_write_span_on_card_bitwise_equals_cpu(card, int8):
    rng = np.random.RandomState(13)
    shape = (12, 2, 8, 64)
    kc = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    vc = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    kn = torch.from_numpy(rng.randn(4, 5, 2, 64).astype(np.float32))
    vn = torch.from_numpy(rng.randn(4, 5, 2, 64).astype(np.float32))
    idx = (torch.tensor([[3, 7, 0], [1, 9, 4], [2, 0, 0], [0, 0, 0]],
                        dtype=torch.int32),
           torch.tensor([5, 3, 1, 0], dtype=torch.int32),
           torch.tensor([6, 15, 2, -1], dtype=torch.int32))
    if int8:
        kc, vc = (kc * 40).to(torch.int8), (vc * 40).to(torch.int8)
        scales = [torch.from_numpy(rng.rand(*shape[:3]).astype(np.float32))
                  for _ in range(2)]
    else:
        kc, vc, kn, vn = (t.bfloat16() for t in (kc, vc, kn, vn))
        scales = []
    outs = {}
    for dev in ("cpu", "cuda"):
        args = [t.clone().to(dev) for t in (kc, vc, kn, vn) + idx]
        sc = [t.clone().to(dev) for t in scales]
        kw = dict(zip(("k_scale", "v_scale"), sc))
        outs[dev] = [t.cpu() for t in pa.paged_cache_write_span(*args,
                                                                **kw)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(a, b)


def test_spec_target_as_draft_on_card(card):
    """The bf16 target as its own draft model on the card: every
    request completes, drafts are accepted, the draft's decode launches
    went through the paged kernel, both pools end empty."""
    model = _tiny_bf16(card)
    dp = DraftModelProposer(model, num_pages=64, page_size=8,
                            prefill_buckets=[64], batch_buckets=[4],
                            pages_buckets=[8])
    eng = ServingEngine(model, device=card, proposer=dp, spec_k=4,
                        spec_buckets=[4], **SERVE_KW)
    n0 = pa.paged_attention_decode.launches
    out = _serve(eng, _serve_prompts())
    assert [len(o) for o in out] == [10] * 4
    snap = eng.metrics.snapshot()
    assert snap["spec_steps"] > 0 and snap["spec_acceptance_rate"] > 0
    assert pa.paged_attention_decode.launches - n0 > 0
    assert dp.num_propose_failures == 0 and not dp.disabled
    assert dp.num_draft_launches > 0
    assert not dp._states and dp.allocator.num_used == 0
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0


def test_snapshot_resume_on_card(card):
    """fp32 on the card: snapshot mid-run, JSON round trip, vacate,
    from_snapshot on a fresh engine: every request completes with the
    uninterrupted run's tokens; both engines end with zero pages."""
    import json
    model = _tiny_llama(card)
    prompts = _serve_prompts(seed=14)
    want = _serve(ServingEngine(model, device=card, **SERVE_KW), prompts)
    eng = ServingEngine(model, device=card, decode_steps=2, **SERVE_KW)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
    for _ in range(3):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    eng.vacate()
    assert eng.allocator.num_used == 0
    res = ServingEngine.from_snapshot(model, snap, device=card,
                                      decode_steps=2, **SERVE_KW)
    res.run()
    for rid, w in zip(rids, want):
        got = (res.requests[rid] if rid in res.requests
               else eng.requests[rid]).output_ids
        assert got == w
    res.reset_prefix_cache()
    assert res.allocator.num_used == 0


# ------------------------------------------------------ host spill tier
def _filled_engine(card, kv_dtype, host_pages=16):
    """A tiny bf16 engine whose every page holds seeded random bytes
    (int8 values and fp32 scales too)."""
    eng = ServingEngine(_tiny_bf16(card), device=card, kv_dtype=kv_dtype,
                        host_spill_pages=host_pages, **SERVE_KW)
    gen = torch.Generator(device=card).manual_seed(6)
    for t in eng._page_tensors:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=card).to(torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=gen, device=card))
    return eng


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_demote_promote_round_trip_is_bitwise_on_card(card, kv_dtype):
    """Pages gathered on the card and written back into other pages are
    bitwise the originals, scale rows included; the write enqueues with
    no host sync, and a pinned buffer reused right after it does not
    disturb the copy in flight."""
    from paddle_tpu_torch.serving.kv_cache import encode_page_payload
    eng = _filled_engine(card, kv_dtype)
    src, dst = [3, 5, 9, 11], [20, 21, 30, 40]
    payloads = eng._gather_page_payloads(src)
    assert payloads[1] == encode_page_payload(
        [t[5].cpu() for t in eng._page_tensors])
    records = [eng._page_records(p) for p in payloads]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._scatter_page_records(dst, records)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    scratch = torch.empty(len(payloads[0]) * 8, dtype=torch.uint8,
                          pin_memory=True)
    scratch.fill_(0xAB)
    torch.cuda.synchronize()
    for t in eng._page_tensors:
        assert torch.equal(t[dst], t[src])


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_paged_kernel_over_promoted_pages_equals_originals(card, kv_dtype):
    """The paged-decode kernel over promoted copies of the pages gives
    bitwise the output it gives over the originals."""
    eng = _filled_engine(card, kv_dtype)
    src = [2, 3, 4, 5, 6, 7]
    dst = [40, 41, 42, 43, 44, 45]
    eng._scatter_page_records(
        dst, [eng._page_records(p) for p in eng._gather_page_payloads(src)])
    layer = eng.kv_caches[1]
    H, D = eng.num_heads, eng.head_dim
    q = torch.randn(2, H, D, device=card, dtype=torch.bfloat16,
                    generator=torch.Generator(device=card).manual_seed(8))
    sl = torch.tensor([45, 23], dtype=torch.int32, device=card)
    outs = []
    for pages in (src, dst):
        bt = torch.tensor([pages + [0] * 2, pages[3:] + [0] * 5],
                          dtype=torch.int32, device=card)
        kw = dict(k_scale=layer[2], v_scale=layer[3]) if kv_dtype else {}
        outs.append(pa.paged_attention_decode(q, layer[0], layer[1], bt, sl,
                                              **kw))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0].float()).all()
    assert torch.equal(outs[0], outs[1])


def test_demotion_makes_one_device_to_host_copy(card):
    """A demotion of 6 pages x 2 layers x (K, V, K scales, V scales)
    moves to the host in ONE copy (counted by the profiler); the
    promotion back in one host-to-device copy of the payloads."""
    eng = _filled_engine(card, "int8")
    pids = [2, 3, 4, 5, 6, 7]
    eng._gather_page_payloads(pids)            # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        payloads = eng._gather_page_payloads(pids)
        torch.cuda.synchronize()
    d2h = [e for e in prof.events() if "Memcpy DtoH" in e.name]
    assert len(d2h) == 1, [e.name for e in prof.events() if "emcpy" in e.name]
    records = [eng._page_records(p) for p in payloads]
    with torch.profiler.profile(activities=acts) as prof:
        eng._scatter_page_records([30, 31, 32, 33, 34, 35], records)
        torch.cuda.synchronize()
    h2d = [e for e in prof.events() if "Memcpy HtoD" in e.name]
    assert len(h2d) == 1, [e.name for e in prof.events() if "emcpy" in e.name]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_spill_on_equals_off_on_card(card, kv_dtype):
    """The CPU test's shared-prefix workload through a 16-page pool on
    the card (bf16 model): spill on gives spill off's tokens, with pages
    demoted and promoted through the paged kernel's caches."""
    model = _tiny_bf16(card)
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 128, (24,)).tolist()
    tails = [rng.randint(0, 128, (24,)).tolist() for _ in range(8)]
    kw = dict(num_pages=16, page_size=8, token_budget=64, batch_buckets=[4],
              prefill_buckets=[64], pages_buckets=[8], max_batch_size=4,
              kv_dtype=kv_dtype)
    outs = []
    for host in (0, 64):
        eng = ServingEngine(model, device=card, host_spill_pages=host, **kw)
        out = []
        for _ in range(2):
            for t in tails:
                rid = eng.add_request(shared + t, max_new_tokens=4)
                out.append(eng.run()[rid])
        outs.append(out)
        c = eng.metrics.counters
        if host:
            assert c["kv_pages_demoted"] > 0 and c["kv_pages_promoted"] > 0
            assert c["radix_evict_dropped"] == 0
        eng.reset_prefix_cache()
        assert eng.allocator.num_used == 0
        assert eng.host_store is None or eng.host_store.num_used == 0
    assert outs[0] == outs[1]


def test_adopt_prefix_across_engines_on_card(card):
    """A prefix exported by one engine and adopted by another on the same
    card serves the same tokens as a cache hit."""
    model = _tiny_bf16(card)
    prompt = list(range(3, 43))
    donor = ServingEngine(model, device=card, **SERVE_KW)
    rid = donor.add_request(prompt, max_new_tokens=6)
    want = donor.run()[rid]
    n, payloads = donor.export_prefix(prompt)
    assert n == 40 and len(payloads) == 5
    other = ServingEngine(model, device=card, **SERVE_KW)
    assert other.adopt_prefix(prompt[:n], payloads) == 5
    rid = other.add_request(prompt, max_new_tokens=6)
    assert other.run()[rid] == want
    c = other.metrics.counters
    assert c["prefix_hits"] == 1 and c["kv_pages_adopted"] == 5
    for eng in (donor, other):
        eng.reset_prefix_cache()
        assert eng.allocator.num_used == 0


# -------------------------------------- paged splits and the process fleet
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_rows_are_bitwise_independent_of_the_batch(card, int8):
    """Serve's batch (B 16, KVH 8, G 4, D 128, page 16, a 72-page table,
    a pad row): each row's output is bitwise the same in a batch of 16
    whose other rows are pad rows, and in one whose other rows have
    other lengths (a row's splits depend on its own length alone)."""
    rng = np.random.RandomState(5)
    lens = rng.randint(128, 72 * 16 + 1, size=16)
    lens[-1] = 0
    q, kc, vc, bt, sl = (torch.from_numpy(a).to(card) for a in _paged_case(
        B=16, KVH=8, G=4, D=128, page=16, max_pages=72, seq_lens=lens,
        seed=9))
    q, extra = q.bfloat16(), {}
    if int8:
        (kc, ks), (vc, vs) = pa.quantize_kv(kc), pa.quantize_kv(vc)
        extra = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.bfloat16(), vc.bfloat16()
    full = pa.paged_attention_decode(q, kc, vc, bt, sl, **extra)
    others = torch.from_numpy(
        rng.randint(1, 72 * 16 + 1, size=16).astype(np.int32)).to(card)
    for r in range(15):
        alone = torch.zeros_like(sl)
        alone[r] = sl[r]
        mixed = others.clone()
        mixed[r] = sl[r]
        for batch in (alone, mixed):
            got = pa.paged_attention_decode(q, kc, vc, bt, batch, **extra)
            assert torch.equal(got[r], full[r]), r
    torch.cuda.synchronize()


def test_process_fleet_prefill_to_decode_on_card(card, tmp_path):
    """Two worker processes on the card (TINY in bf16, head_dim 64): a
    prefill worker and a decode worker; every request's KV pages travel
    to the decode worker, which decodes it through the paged kernel;
    streams equal an in-process engine's on the same grid, both pools
    end empty, and the decode worker's paged launches are its decode
    launches x 2 layers."""
    import time
    from paddle_tpu_torch.serving import ProcessFleet
    from paddle_tpu_torch.serving.fleet.worker import build_model
    model_spec = {"kind": "llama", "config": dict(TINY, dtype="bfloat16"),
                  "seed": 3}
    rng = np.random.RandomState(16)
    prompts = [(rng.randint(0, 128, int(n)).tolist(), 10)
               for n in rng.randint(20, 41, 4)]
    # the in-process run builds the path's kernels: the workers load them
    ref = ServingEngine(build_model(model_spec), device=card, **SERVE_KW)
    want = _serve(ref, prompts)
    base = {"model": model_spec, "engine": SERVE_KW,
            "heartbeat_interval_s": 0.05}
    pf = ProcessFleet({"p0": dict(base, role="prefill"),
                       "d0": dict(base, role="decode")}, dead_after_s=60.0,
                      stderr_dir=str(tmp_path / "logs"))
    try:
        t0 = time.monotonic()
        while not all(w.ready for w in pf.workers.values()):
            pf.pump()
            assert time.monotonic() - t0 < 180, "workers not ready"
            time.sleep(0.01)
        handles = [pf.submit(p, max_new_tokens=m) for p, m in prompts]
        res = pf.run(timeout_s=180)
        assert [res[h.request_id] for h in handles] == want
        c = pf.counters
        assert c["handoffs_completed"] == len(prompts)
        assert c["kv_pages_shipped"] >= len(prompts)
        assert c["requests_lost"] == c["funnel_conflicts"] == 0
        for name in pf.workers:
            st = pf.request_stats(name, reset_prefix_cache=True)
            assert st["allocator_ok"] and st["kv_used_pages"] == 0, st
        st = pf.workers["d0"].last_stats
        assert st["decode_launches"] > 0
        assert st["kernel_launches"]["paged_attention_decode"] == \
            2 * st["decode_launches"]
    finally:
        pf.shutdown()
    assert [w.poll() for w in pf.workers.values()] == [0, 0]


# ------------------------------------------------------------- MoE (Qwen2)
def _tied_bf16_gates(T, E, seed):
    """bf16 softmax rows with many exact ties: logits rounded to a coarse
    grid, so equal probabilities recur within and across rows."""
    rng = np.random.RandomState(seed)
    logits = np.round(rng.randn(T, E) * 2) / 2
    logits[::7] = 0.0                                 # uniform rows
    return torch.softmax(torch.from_numpy(logits).float(), -1).to(
        torch.bfloat16)


def test_moe_routing_on_card_equals_cpu_with_tied_bf16_gates(card):
    """Top-8 of 64 over bf16 gates full of exact ties, at a capacity that
    drops assignments: every routing output and the dispatched slab are
    bitwise the CPU's (tie order and grouping order match across
    devices)."""
    from paddle_tpu_torch.distributed import moe
    T, E, k = 512, 64, 8
    g = _tied_bf16_gates(T, E, 0)
    x = torch.randn(T, 64, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    for capacity in (64, 24):
        on_card = moe._route(g.to(card), k, capacity)
        on_cpu = moe._route(g, k, capacity)
        for a, b in zip(on_card, on_cpu):
            assert torch.equal(a.cpu(), b)
        assert (on_cpu.counts > capacity).any()
        slab = moe.moe_dispatch_combine(x.to(card), g.to(card), k,
                                        capacity)[0]
        assert torch.equal(slab.cpu(),
                           moe.moe_dispatch_combine(x, g, k, capacity)[0])


def test_moe_layer_on_card_is_sync_free_and_its_combine_repeats(card):
    """One bf16 MoELayer forward + backward under set_sync_debug_mode
    ("error") (a host sync in routing, the experts or the combine
    raises); two combines of the same inputs bitwise equal."""
    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.models.qwen2_moe import _ExpertMLP
    d, inter, E, k = 128, 64, 16, 4
    g = torch.Generator().manual_seed(2)
    layer = moe.MoELayer(
        d, experts=[_ExpertMLP(d, inter, device="cpu", generator=g)
                    for _ in range(E)],
        gate=moe.TopKGate(d, E, topk=k, device="cpu", generator=g), topk=k)
    x = torch.randn(2, 256, d, generator=g)
    layer = layer.to(card, torch.bfloat16)
    xc = x.to(card, torch.bfloat16).requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = layer(xc)
        out.float().square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(xc.grad).all()
    assert torch.isfinite(layer.experts.down_proj.weight.grad).all()
    with torch.no_grad():
        xf = xc.detach().reshape(-1, d)
        gates = layer.gate(xf)
        expert_in, info, _ = moe.moe_dispatch_combine(xf, gates, k, 64)
        eo = layer.experts(expert_in)
        assert torch.equal(moe.moe_combine(eo, info, xf.shape[0]),
                           moe.moe_combine(eo, info, xf.shape[0]))


def test_qwen2_moe_tiny_bf16_steps_on_card_run_the_kernels(card):
    """qwen2_moe_tiny at head_dim 64 in bf16 takes three fused-AdamW steps
    (fp32 master, bf16 moments) on the card: finite, falling losses; each
    step launched the wgmma flash forward, dQ and dK/dV once per layer
    and the AdamW kernel once."""
    from paddle_tpu_torch.models import Qwen2MoeForCausalLM, qwen2_moe_tiny
    cfg = qwen2_moe_tiny(hidden_size=128, num_attention_heads=2,
                         num_key_value_heads=1)
    model = Qwen2MoeForCausalLM(cfg, device=card, dtype=torch.bfloat16,
                                generator=torch.Generator(card)
                                .manual_seed(3))
    opt = AdamW(1e-3, parameters=model.parameters(), multi_precision=True,
                fused=True, moment_dtype="bfloat16")
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, 256, (2, 64))).to(card)
    counters = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    for fn in counters:
        fn.launches = fn.sm90_launches = 0
    fo.fused_adamw_bucket.launches = 0
    losses = []
    for _ in range(3):
        loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    torch.cuda.synchronize()
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert [(fn.launches, fn.sm90_launches) for fn in counters] == \
        [(6, 6)] * 3
    assert fo.fused_adamw_bucket.launches == 3
