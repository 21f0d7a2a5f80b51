"""Tests of the port that need the CUDA card (marker `cuda`); each skips
without one. This file imports torch and the port only — no JAX — so it
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.)
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import ServingEngine

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
