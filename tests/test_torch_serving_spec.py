"""The port's speculative decoding against the reference on the CPU.

The pieces: `NgramProposer.propose_for` equal to the reference's on
seeded histories; `paged_cache_write_span` bitwise equal to the
reference's scatter (bf16 and int8, scales included) on every live
slot; `forward_paged_verify`'s logits within 1e-5 of the reference's
at fp32 (full-width and int8 KV). The engine: the reference test's 16
mixed requests (half of them repetitive) through the port's plain
engine, its NgramProposer spec engine (K=4) and the reference's spec
engine, with the same seeded weights and pinned single buckets, greedy
at fp32: tokens identical (exactly), acceptance > 0, more than one token
per verify step. The target as its own draft model accepts every draft;
a forced all-reject storm changes nothing and leaks no page; sampled
acceptance follows the reference's rule; the capability table's reasons
are the reference's strings.

The reference engine drains once, in a module fixture.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.kernels import paged_attention as ref_pa
from paddle_tpu.serving import NgramProposer as JaxNgram
from paddle_tpu.serving import RequestTracer as JaxTracer
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import errors as ref_errors
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.serving import (AdapterRegistry, DraftModelProposer,
                                      EngineFailure, NgramProposer,
                                      RequestTracer, RetryPolicy,
                                      ServingEngine, TransientDeviceError,
                                      UnsupportedFeature)
from paddle_tpu_torch.serving import errors as port_errors
from paddle_tpu_torch.serving.engine import _verify_accept
from paddle_tpu_torch.utils import faults

from _torch_parity import (assert_traces_equal, counting_clock,
                           model_pair, trace_view)

ENGINE_KW = dict(num_pages=96, page_size=8, token_budget=96,
                 batch_buckets=[16], prefill_buckets=[32],
                 pages_buckets=[8], temperature=0.0)
SPEC = dict(spec_k=4, spec_buckets=[4])


def _mixed_prompts(n=16, seed=42):
    """The reference test's workload: mixed lengths, even requests
    repetitive (the ngram-friendly regime), odd ones random."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            cycle = rng.randint(0, 128, (rng.randint(2, 5),)).tolist()
            p = (cycle * 8)[:rng.randint(8, 24)]
        else:
            p = rng.randint(0, 128, (rng.randint(2, 25),)).tolist()
        out.append((p, int(rng.randint(4, 14))))
    return out


def _run(eng, prompts):
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def models():
    return model_pair(seed=1)


@pytest.fixture(scope="module")
def reference_spec(models):
    """The reference spec engine's tokens, metrics summary and trace
    view (its tracer on a counting clock)."""
    tracer = JaxTracer(clock_ns=counting_clock())
    eng = JaxEngine(models[0], proposer=JaxNgram(), trace=tracer,
                    **ENGINE_KW, **SPEC)
    out = _run(eng, _mixed_prompts())
    return out, eng.metrics.summary(), trace_view(tracer)


@pytest.fixture(scope="module")
def plain(models):
    return _run(ServingEngine(models[1], device="cpu", **ENGINE_KW),
                _mixed_prompts())


# ---------------------------------------------------------------- pieces
def test_ngram_proposals_equal_the_reference():
    rng = np.random.RandomState(0)
    port, ref = NgramProposer(max_ngram=3), JaxNgram(max_ngram=3)
    cases = [([1, 2, 3, 9, 1, 2, 3], 2), ([5, 7, 5, 8, 5], 1),
             ([1, 2, 1, 2, 1], 4), ([1, 2, 3, 4], 4), ([7], 3)]
    for _ in range(200):
        cycle = rng.randint(0, 6, (rng.randint(1, 5),)).tolist()
        hist = (cycle * 10)[:rng.randint(1, 30)]
        hist += rng.randint(0, 6, (rng.randint(0, 4),)).tolist()
        cases.append((hist, int(rng.randint(0, 6))))
    drafted = 0
    for hist, k in cases:
        got = port.propose_for(hist, k)
        assert got == ref.propose_for(hist, k), (hist, k)
        drafted += bool(got)
    assert drafted > len(cases) // 3
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=0)


def _span_case(seed, int8):
    rng = np.random.RandomState(seed)
    pages, KVH, page, D = 12, 2, 8, 64
    kc = rng.randn(pages, KVH, page, D).astype(np.float32)
    vc = rng.randn(pages, KVH, page, D).astype(np.float32)
    kn = rng.randn(4, 5, KVH, D).astype(np.float32)
    vn = rng.randn(4, 5, KVH, D).astype(np.float32)
    bt = np.array([[3, 7, 0], [1, 9, 4], [2, 0, 0], [0, 0, 0]], np.int32)
    lengths = np.array([5, 3, 1, 0], np.int32)     # the last a pad row
    starts = np.array([6, 15, 2, -1], np.int32)    # row 0 crosses a page
    if int8:
        kc = (kc * 40).astype(np.int8)
        vc = (vc * 40).astype(np.int8)
        ks = rng.rand(pages, KVH, page).astype(np.float32)
        vs = rng.rand(pages, KVH, page).astype(np.float32)
        return kc, vc, kn, vn, bt, lengths, starts, ks, vs
    return kc, vc, kn, vn, bt, lengths, starts


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cache_write_span_bitwise_equals_reference(int8):
    """Every live slot (values, and scales for int8) bitwise equal to the
    reference's scatter; the pad page bitwise unchanged in the port; a
    second write of the same span changes nothing (idempotent)."""
    import jax.numpy as jnp
    kc, vc, kn, vn, bt, lengths, starts, *scales = _span_case(5, int8)
    # bf16: both sides round the same fp32 arrays to bf16 (RNE)
    jdt, tdt = (None, None) if int8 else (jnp.bfloat16, torch.bfloat16)

    def ref_arr(a, cast=True):
        return jnp.asarray(a, jdt if cast and a.dtype == np.float32 else None)

    def port_arr(a, cast=True):
        t = torch.from_numpy(a.copy())
        return t.to(tdt) if cast and tdt is not None else t

    vals = (kc, vc, kn, vn)
    idx = (bt, lengths, starts)
    want = ref_pa.paged_cache_write_span(
        *map(ref_arr, vals), *(jnp.asarray(a) for a in idx),
        **dict(zip(("k_scale", "v_scale"),
                   (ref_arr(s, False) for s in scales))))
    targs = tuple(map(port_arr, vals)) + tuple(
        torch.from_numpy(a) for a in idx)
    tkw = dict(zip(("k_scale", "v_scale"),
                   (port_arr(s, False) for s in scales)))
    before = [t.clone() for t in targs[:2] + tuple(tkw.values())]
    got = pa.paged_cache_write_span(*targs, **tkw)
    for g, w, b in zip(got, want, before):
        g = g.float().numpy()
        assert np.array_equal(g[1:], np.asarray(w, np.float32)[1:])
        assert np.array_equal(g[0], b.float().numpy()[0])    # pad page
    again = [t.clone() for t in got]
    pa.paged_cache_write_span(*targs, **tkw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_forward_paged_verify_logits_match_reference(models, kv_dtype):
    """Three rows with 4, 2 and 0 drafts (and a pad row) over seeded
    paged caches: logits at every live position within 1e-5 of the
    reference's; the span's cache writes agree too."""
    ref, port = models
    rng = np.random.RandomState(9)
    cfg = port.cfg
    D = cfg.hidden_size // cfg.num_attention_heads
    shape = (20, cfg.num_key_value_heads, 8, D)
    caches = []
    for _ in range(cfg.num_hidden_layers):
        k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        if kv_dtype == "int8":
            caches.append(((k * 30).astype(np.int8), (v * 30).astype(np.int8),
                           rng.rand(*shape[:3]).astype(np.float32) / 30,
                           rng.rand(*shape[:3]).astype(np.float32) / 30))
        else:
            caches.append((k, v))
    bt = np.zeros((4, 5), np.int32)
    bt[0, :3] = [4, 8, 2]
    bt[1, :5] = [1, 3, 5, 6, 7]
    bt[2, :1] = [9]
    ids = rng.randint(0, 128, (4, 5)).astype(np.int32)
    sl = np.array([13, 31, 4, 0], np.int32)
    dl = np.array([4, 2, 0, 0], np.int32)
    kv = [tuple(torch.from_numpy(a.copy()) for a in layer)
          for layer in caches]
    with torch.inference_mode():
        got, _ = port.forward_paged_verify(
            torch.from_numpy(ids.astype(np.int64)), kv, torch.from_numpy(bt),
            torch.from_numpy(sl), torch.from_numpy(dl.astype(np.int64)))
    with no_grad():
        want, rcaches = ref.forward_paged_verify(
            Tensor(ids), [tuple(Tensor(a) for a in layer)
                          for layer in caches],
            Tensor(bt), Tensor(sl), Tensor(dl))
    want = np.asarray(want._data)
    got = got.numpy()
    for b in range(3):
        live = int(dl[b]) + 1
        np.testing.assert_allclose(got[b, :live], want[b, :live],
                                   rtol=0, atol=1e-5)
    assert np.isfinite(got).all()       # the pad row stays finite
    for layer, rlayer in zip(kv, rcaches):
        for g, w in zip(layer, rlayer):
            np.testing.assert_allclose(g.float().numpy()[1:],
                                       np.asarray(w._data).astype(
                                           np.float32)[1:], rtol=0,
                                       atol=1e-5)


def test_sampled_acceptance_follows_the_reference_rule():
    """The one-hot proposal rule on hand-made distributions: a draft
    holding all of p is accepted whatever u; a draft of zero mass never
    is, and the position then samples p without it; the bonus position
    samples p itself."""
    V = 6
    lg = torch.full((1, 3, V), -1e9)
    lg[0, 0, 2] = 0.0                   # p_0 = one-hot(2)
    lg[0, 1, :] = 0.0                   # p_1 uniform
    lg[0, 1, 4] = -1e9                  # ... without token 4
    lg[0, 2, 5] = 0.0                   # bonus p_2 = one-hot(5)
    ids = torch.tensor([[9, 2, 4]])
    dl = torch.tensor([2])
    u = torch.tensor([[0.999, 0.0]])
    g = torch.zeros(1, 3, V)
    g[0, 1, 4] = 50.0                   # noise pushing the rejected draft
    toks, n_acc, ok = _verify_accept(lg, ids, dl, 1.0, 0, 1.0, (u, g))
    assert int(n_acc[0]) == 1 and bool(ok[0])
    assert int(toks[0, 0]) == 2         # the accepted draft
    assert int(toks[0, 1]) != 4         # residual: p_1 with 4 removed
    greedy, n_g, _ = _verify_accept(lg, ids, dl, 0.0, 0, 1.0, None)
    assert int(n_g[0]) == 1 and greedy[0].tolist()[:2] == [2, 0]


# ---------------------------------------------------------------- engine
def test_spec_greedy_equals_plain_and_reference(models, plain,
                                                reference_spec):
    """16 mixed requests: NgramProposer K=4 tokens == plain decode ==
    the reference's spec engine; acceptance > 0; > 1 token per verify
    step; the counters agree with the reference's; full reclamation."""
    eng = ServingEngine(models[1], device="cpu", proposer=NgramProposer(),
                        **ENGINE_KW, **SPEC)
    out = _run(eng, _mixed_prompts())
    ref_out, ref_snap, _ = reference_spec
    assert out == plain
    assert out == ref_out
    snap = eng.metrics.snapshot()
    assert snap["spec_steps"] > 0 and snap["spec_accepted_tokens"] > 0
    assert snap["spec_acceptance_rate"] > 0
    assert snap["spec_tokens_per_step"] > 1.0
    for key in ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens",
                "spec_emitted_tokens", "spec_rollback_tokens"):
        assert snap[key] == ref_snap[key], key
    assert all(p.startswith(("chunk:", "verify:"))
               for r in eng.timeline() for p in r["programs"])
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0
    eng.allocator.check_invariants()


def test_spec_traces_equal_the_reference(models, reference_spec):
    """The spec drain traced on the same counting clock as the
    reference's: every request's spans (its verify_step spans among
    them) and marks equal the reference's by name, stamps and
    arguments, engine names excepted."""
    tracer = RequestTracer(clock_ns=counting_clock())
    _run(ServingEngine(models[1], device="cpu", proposer=NgramProposer(),
                       trace=tracer, **ENGINE_KW, **SPEC), _mixed_prompts())
    assert_traces_equal(trace_view(tracer), reference_spec[2],
                        ("queue_wait", "prefill_chunk", "verify_step"),
                        ("admitted", "first_token"))


def test_target_as_draft_accepts_every_draft(models, plain):
    """DraftModelProposer with the target as its own draft: every scored
    draft accepted, tokens equal plain decode's, more than two tokens a
    verify step, both pools empty at the end."""
    model = models[1]
    dp = DraftModelProposer(model, num_pages=96, page_size=8,
                            prefill_buckets=[32], batch_buckets=[16],
                            pages_buckets=[8])
    eng = ServingEngine(model, device="cpu", proposer=dp, **ENGINE_KW,
                        **SPEC)
    out = _run(eng, _mixed_prompts(8))
    assert out == plain[:8]
    snap = eng.metrics.snapshot()
    assert snap["spec_acceptance_rate"] == 1.0
    assert snap["spec_tokens_per_step"] > 2.0
    assert dp.num_draft_launches > 0 and not dp.disabled
    assert not dp._states and dp.allocator.num_used == 0
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0


def test_forced_all_reject_storm_leaks_nothing(models):
    """Every draft garbage: tokens unchanged, nothing accepted, every
    rejected slot rolled back, invariants every step, no page left."""
    model = models[1]
    plain_eng = ServingEngine(model, device="cpu", **ENGINE_KW)
    rp = plain_eng.add_request([5, 6, 7, 8] * 4, max_new_tokens=10)
    want = plain_eng.run()[rp]
    eng = ServingEngine(model, device="cpu", proposer=NgramProposer(),
                        **ENGINE_KW, **SPEC)
    with faults.injected("serving.spec.draft_storm", payload=True,
                         times=-1):
        rid = eng.add_request([5, 6, 7, 8] * 4, max_new_tokens=10)
        steps = 0
        while eng.has_work():
            eng.step()
            eng.allocator.check_invariants()
            steps += 1
            assert steps < 200
    assert eng.requests[rid].output_ids == want
    snap = eng.metrics.snapshot()
    assert snap["spec_accepted_tokens"] == 0
    assert snap["spec_rollback_tokens"] > 0
    assert snap["spec_tokens_per_step"] == 1.0
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0


def test_transient_retry_and_nan_quarantine(models):
    """A transient verify failure retries the identical launch (same
    tokens); a NaN on one row quarantines that request alone."""
    model = models[1]
    prompts = _mixed_prompts(4, seed=3)
    clean = _run(ServingEngine(model, device="cpu", proposer=NgramProposer(),
                               **ENGINE_KW, **SPEC), prompts)
    eng = ServingEngine(model, device="cpu", proposer=NgramProposer(),
                        retry_policy=RetryPolicy(max_retries=3, base_s=0.0,
                                                 sleep=lambda s: None),
                        **ENGINE_KW, **SPEC)
    with faults.injected("serving.engine.verify_step",
                         exc=TransientDeviceError("UNAVAILABLE"), times=2):
        assert _run(eng, prompts) == clean
    assert eng.metrics.counters["step_retries"] == 2
    eng = ServingEngine(model, device="cpu", proposer=NgramProposer(),
                        enable_prefix_cache=False, **ENGINE_KW, **SPEC)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in prompts]
    while not eng.metrics.counters["spec_steps"]:
        eng.step()
    with faults.injected("serving.engine.nan_logits", payload=[0],
                         times=1):
        eng.step()
    eng.run()
    assert eng.metrics.counters["requests_quarantined"] == 1
    done = [eng.requests[r] for r in rids]
    assert sum(r.finish_reason == "quarantined" for r in done) == 1
    assert eng.allocator.num_used == 0


def test_sampled_spec_is_reproducible(models):
    """temperature > 0: two engines with one seed give the same tokens,
    all in the vocabulary, and accept some drafts."""
    outs = []
    for _ in range(2):
        eng = ServingEngine(models[1], device="cpu",
                            proposer=NgramProposer(), seed=11,
                            **dict(ENGINE_KW, temperature=0.7, top_k=20),
                            **SPEC)
        outs.append(_run(eng, _mixed_prompts(6)))
    assert outs[0] == outs[1]
    assert all(0 <= t < 128 for o in outs[0] for t in o)


def _broken_draft(model):
    """A draft proposer whose every launch raises."""
    dp = DraftModelProposer(model, num_pages=64, page_size=8,
                            prefill_buckets=[32], batch_buckets=[16],
                            pages_buckets=[8])

    def boom(*a, **k):
        raise RuntimeError("draft launch failed")

    dp.model = type("Broken", (), {"forward_paged_prefill": boom,
                                   "forward_paged_decode": boom})()
    return dp


def test_draft_proposer_disable_is_observable(models):
    """On the CPU, as in the reference: three failing rounds disable the
    draft proposer with a warning and a recorded reason, each failure
    counted; the engine verifies on without drafts."""
    model = models[1]
    dp = _broken_draft(model)
    eng = ServingEngine(model, device="cpu", proposer=dp, **ENGINE_KW,
                        **SPEC)
    with pytest.warns(RuntimeWarning, match="disabled"):
        out = _run(eng, _mixed_prompts(3))
    assert dp.disabled and "3 consecutive" in dp.disabled_reason
    assert dp.num_propose_failures == 3
    assert [len(o) for o in out] == [m for _, m in _mixed_prompts(3)]


def test_draft_failure_on_the_card_fails_the_engine(models):
    """A draft model on the card: its failing launch is not absorbed
    (no skipped round, no disable), it fails the engine step to the
    snapshot EngineFailure carries, with the launch's error as cause."""
    model = models[1]
    dp = _broken_draft(model)
    dp.device = torch.device("cuda")       # where the proposer re-raises
    dp._to_device = torch.from_numpy       # the tensors stay on the CPU
    eng = ServingEngine(model, device="cpu", proposer=dp, **ENGINE_KW,
                        **SPEC)
    for p, m in _mixed_prompts(3):
        eng.add_request(p, max_new_tokens=m)
    with pytest.raises(EngineFailure) as ei:
        eng.run()
    assert "draft launch failed" in str(ei.value.__cause__)
    assert len(ei.value.snapshot["requests"]) == 3
    assert dp.num_propose_failures == 0 and not dp.disabled


def test_conflict_table_and_reasons_equal_the_reference(models):
    """FEATURE_CONFLICTS row for row, and each conflicting pair the port
    can be asked for refused with the reference's reason."""
    assert port_errors.FEATURE_CONFLICTS == ref_errors.FEATURE_CONFLICTS
    model = models[1]
    reg = AdapterRegistry.for_model(model, device="cpu")
    cases = [(dict(proposer=NgramProposer(), decode_steps=2),
              {"proposer", "multi_step_decode"}),
             (dict(proposer=NgramProposer(), lora=reg),
              {"proposer", "lora"}),
             (dict(proposer=NgramProposer(), role="prefill"),
              {"proposer", "prefill_role"}),
             (dict(host_spill_pages=4, enable_prefix_cache=False),
              {"host_spill", "no_prefix_cache"})]
    for kw, pair in cases:
        with pytest.raises(UnsupportedFeature) as ei:
            ServingEngine(model, device="cpu", **dict(ENGINE_KW, **kw))
        assert str(ei.value) == ref_errors.FEATURE_CONFLICTS[frozenset(pair)]
        assert set(ei.value.features) == pair
