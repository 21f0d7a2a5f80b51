"""The port's multi-step decode (`decode_steps=K`) against the reference
engine and against its own K=1 engine on the CPU.

The reference test's 16-request mixed workload (tests/test_serving_multi.py:
a shared prefix block that produces radix hits, every third request
stopping at an EOS mid-stream) goes through the reference engine at
decode_steps=4 and the port's at K=4 and K=1, with the same seeded
weights (through models/convert.py), the same pinned single-bucket grid,
greedy at fp32: tokens must be identical (exactly), and so with int8
KV. One launch of `forward_paged_decode_multi` is held to the
reference's: tokens, emitted counts and finiteness flags equal, the
written cache slots within 1e-5. The rest holds the port to the
reference test's contracts: the -1 sentinel past an EOS freeze, abort
and TTL at the K boundary, per-launch NaN quarantine, the rollback and
solo isolation of a K-step or verify launch's unattributed poison
(against the reference's tokens), construction validation, per-token
TPOT across K, and LoRA at K=4.

Each reference-engine drain runs once, in a module fixture.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core.autograd import no_grad
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.serving import RequestTracer as JaxTracer
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.serving import (AdapterRegistry, LoRAAdapter,
                                      NgramProposer, PoisonedComputation,
                                      RequestState, RequestTracer,
                                      ServingEngine)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.engine import MAX_DECODE_STEPS
from paddle_tpu_torch.utils import faults

from _torch_parity import (SMALL, assert_traces_equal, counting_clock,
                           model_pair, trace_view)

# single buckets everywhere: identity comparisons hit one launch shape
ENGINE_KW = dict(num_pages=64, page_size=8, token_budget=48,
                 batch_buckets=[16], prefill_buckets=[32],
                 pages_buckets=[8], temperature=0.0)
MULTI = dict(decode_steps=4, multi_buckets=[4])


def _prompts(n=16, shared=6):
    """The reference test's mixed workload (shared 16-token head for
    the first `shared` requests)."""
    rng = np.random.RandomState(7)
    head = rng.randint(0, 128, (16,)).tolist()
    out = []
    for i in range(n):
        if i < shared:
            p = head + rng.randint(0, 128, (rng.randint(1, 6),)).tolist()
        else:
            p = rng.randint(0, 128, (rng.randint(2, 24),)).tolist()
        out.append((p, int(rng.randint(3, 13))))
    return out


def _run_all(eng, prompts):
    rids = [eng.add_request(p, max_new_tokens=m, eos_token_id=e)
            for p, m, e in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def models():
    return model_pair(seed=0)


@pytest.fixture(scope="module")
def workload(models):
    """The 16 requests, every third one given as EOS its own second
    clean token (so the freeze lands mid-launch), from a port K=1 run."""
    base = [(p, m, None) for p, m in _prompts()]
    clean = _run_all(ServingEngine(models[1], device="cpu", **ENGINE_KW),
                     base)
    return [(p, m, clean[i][1] if i % 3 == 0 and m > 2 else None)
            for i, (p, m, _) in enumerate(base)]


@pytest.fixture(scope="module")
def reference_runs(models, workload):
    """The reference engine at decode_steps=4, full-width and int8 KV;
    the full-width run traced on a counting clock (its view under
    "trace")."""
    tracer = JaxTracer(clock_ns=counting_clock())
    runs = {kv: _run_all(JaxEngine(models[0], kv_dtype=kv, **ENGINE_KW,
                                   **MULTI, trace=tracer if kv is None
                                   else None), workload)
            for kv in (None, "int8")}
    runs["trace"] = trace_view(tracer)
    return runs


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_multi_decode_tokens_equal_k1_and_reference(models, workload,
                                                    reference_runs,
                                                    kv_dtype):
    """K=4 tokens == the port's K=1 tokens == the reference engine's
    K=4 tokens, exactly; prefix hits and mid-stream EOS stops happen;
    every launch ran K steps; every page comes back."""
    out1 = _run_all(ServingEngine(models[1], device="cpu",
                                  kv_dtype=kv_dtype, **ENGINE_KW), workload)
    eng = ServingEngine(models[1], device="cpu", kv_dtype=kv_dtype,
                        **ENGINE_KW, **MULTI)
    out4 = _run_all(eng, workload)
    assert out4 == out1
    assert out4 == reference_runs[kv_dtype]
    c = eng.metrics.counters
    assert c["prefix_hits"] > 0
    assert any(r.finish_reason == "stop" for r in eng.requests.values())
    assert c["decode_launch_steps"] == 4 * c["decode_launches"] > 0
    assert eng.metrics.snapshot()["decode_tokens_per_launch"] > 1.0
    ks = [r["decode_k"] for r in eng.timeline() if r["decode_batch"]]
    assert ks and all(k == 4 for k in ks)
    assert all(p.startswith(("chunk:", "multi_decode:"))
               for r in eng.timeline() for p in r["programs"])
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0
    eng.allocator.check_invariants()


def test_multi_decode_traces_equal_the_reference(models, workload,
                                                 reference_runs):
    """The K=4 drain traced on the same counting clock as the
    reference's: every request's spans (its multi_decode_step spans
    among them) and marks equal the reference's by name, stamps and
    arguments, engine names excepted."""
    tracer = RequestTracer(clock_ns=counting_clock())
    _run_all(ServingEngine(models[1], device="cpu", trace=tracer,
                           **ENGINE_KW, **MULTI), workload)
    assert_traces_equal(trace_view(tracer), reference_runs["trace"],
                        ("queue_wait", "prefill_chunk",
                         "multi_decode_step"), ("admitted", "first_token"))


def _paged_state(seed=3):
    """Seeded caches, block tables, lengths and per-row caps/EOS of a
    4-row launch: rows at lengths 5, 17 and 30 and one pad row."""
    rng = np.random.RandomState(seed)
    cfg = LlamaConfig(**SMALL)
    D = cfg.hidden_size // cfg.num_attention_heads
    shape = (24, cfg.num_key_value_heads, 8, D)
    caches = [(rng.randn(*shape).astype(np.float32),
               rng.randn(*shape).astype(np.float32))
              for _ in range(cfg.num_hidden_layers)]
    bt = np.zeros((4, 6), np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :4] = [1, 9, 12, 4]
    bt[2, :6] = [2, 5, 6, 8, 10, 11]
    ids = np.array([5, 17, 99, 0], np.int32)
    sl = np.array([5, 17, 30, 0], np.int32)
    caps = np.array([4, 2, 3, 0], np.int32)
    return caches, bt, ids, sl, caps


def _port_multi(model, caches, bt, ids, sl, caps, eos, K=4):
    kv = [tuple(torch.from_numpy(a.copy()) for a in layer)
          for layer in caches]
    with torch.inference_mode():
        toks, n_emit, ok, _ = model.forward_paged_decode_multi(
            torch.from_numpy(ids.astype(np.int64)), kv,
            torch.from_numpy(bt), torch.from_numpy(sl),
            torch.from_numpy(caps), torch.from_numpy(eos.astype(np.int64)),
            k_steps=K)
    return toks.numpy(), n_emit.numpy(), ok.numpy(), kv


def test_forward_paged_decode_multi_matches_reference(models):
    """One K=4 launch, greedy, fp32, with a row frozen by EOS after its
    first token, one by its cap and a pad row: tokens (with the -1
    sentinel), counts and flags equal the reference's; the caches the
    launch wrote agree within 1e-5."""
    ref, port = models
    caches, bt, ids, sl, caps = _paged_state()
    eos = np.full((4,), -1, np.int32)
    free, _, _, _ = _port_multi(port, caches, bt, ids, sl, caps, eos)
    eos[0] = free[0, 0]                 # row 0 stops at its first token
    toks, n_emit, ok, kv = _port_multi(port, caches, bt, ids, sl, caps, eos)
    with no_grad():
        rt, rn, rok, rcaches = ref.forward_paged_decode_multi(
            Tensor(ids), [(Tensor(k), Tensor(v)) for k, v in caches],
            Tensor(bt), Tensor(sl), Tensor(caps), Tensor(eos),
            jax.random.PRNGKey(0), k_steps=4)
    assert toks.tolist() == np.asarray(rt._data).tolist()
    assert n_emit.tolist() == np.asarray(rn._data).tolist() == [1, 2, 3, 0]
    assert ok.tolist() == np.asarray(rok._data).tolist()
    assert toks[0, 1:].tolist() == [-1, -1, -1]
    assert toks[3].tolist() == [-1] * 4
    for (pk, pv), (rk, rv) in zip(kv, rcaches):
        for got, want in ((pk, rk), (pv, rv)):
            np.testing.assert_allclose(got.numpy()[1:],
                                       np.asarray(want._data)[1:],
                                       rtol=0, atol=1e-5)


def test_eos_freezes_row_mid_launch_with_sentinel(models):
    """A row whose EOS lands mid-launch stops exactly where K=1 stops,
    and the launch's slots past the freeze hold -1."""
    model = models[1]
    prompt = list(range(3, 13))
    ref = ServingEngine(model, device="cpu", **ENGINE_KW)
    rid = ref.add_request(prompt, max_new_tokens=10)
    full = ref.run()[rid]
    stop_at = next(j for j in range(2, len(full)) if full[j] not in full[:j])
    eos = full[stop_at]
    e4 = ServingEngine(model, device="cpu", **ENGINE_KW, **MULTI)
    r4 = e4.add_request(prompt, max_new_tokens=10, eos_token_id=eos)
    assert e4.run()[r4] == full[:stop_at + 1]
    assert e4.requests[r4].finish_reason == "stop"
    # one raw launch, looked at past the freeze point
    e = ServingEngine(model, device="cpu", **ENGINE_KW, **MULTI)
    r = e.add_request(prompt, max_new_tokens=10, eos_token_id=eos)
    e.step()                            # prefill + first token
    req = e.requests[r]
    assert not e.allocator.append_token(req.seq)   # the input's slot
    granted, _ = e._extend_slots(req, 3)
    assert granted == 3
    toks, n_emit, oks, _ = e._run_multi_decode([req], [4], 4)
    exp = min(stop_at, 4)
    assert int(n_emit[0]) == exp
    assert all(int(t) == -1 for t in toks[0, exp:])
    assert bool(oks[0])


def test_abort_and_ttl_at_k_boundary(models):
    """The launch that straddles a deadline delivers its tokens; the
    request is cancelled at the next K boundary, KV donated; abort()
    likewise. The delivered tokens are the K=1 stream's."""
    model = models[1]
    clock = {"t": 0.0}
    eng = ServingEngine(model, device="cpu", clock=lambda: clock["t"],
                        **ENGINE_KW, **MULTI)
    prompt = list(range(2, 14))
    rid = eng.add_request(prompt, max_new_tokens=12, ttl_s=1.0)
    emitted = [t for _, t in eng.step()]        # prefill + token 1
    emitted += [t for _, t in eng.step()]       # one launch: tokens 2-5
    assert len(emitted) == 5
    clock["t"] = 2.0                            # passed during the launch
    assert eng.step() == []
    req = eng.requests[rid]
    assert req.finish_reason == "expired"
    assert req.output_ids == emitted
    assert eng.radix.num_cached_pages > 0       # valid KV donated
    k1 = ServingEngine(model, device="cpu", **ENGINE_KW)
    r1 = k1.add_request(prompt, max_new_tokens=12)
    assert k1.run()[r1][:5] == emitted
    eng2 = ServingEngine(model, device="cpu", **ENGINE_KW, **MULTI)
    rid2 = eng2.add_request(prompt, max_new_tokens=12)
    eng2.step()
    eng2.step()
    assert eng2.abort(rid2)
    assert eng2.step() == []
    assert eng2.requests[rid2].finish_reason == "abort"
    assert len(eng2.requests[rid2].output_ids) == 5
    for e in (eng, eng2):
        e.reset_prefix_cache()
        assert e.allocator.num_used == 0


def test_nan_quarantine_is_per_launch(models):
    """nan_logits on one row of a 4-row launch: that request is
    quarantined with none of the launch's tokens; the others complete
    as in an unfaulted run; every page comes back."""
    model = models[1]
    rng = np.random.RandomState(11)
    prompts = [(rng.randint(0, 128, (10,)).tolist(), 8, None)
               for _ in range(4)]
    kw = dict(ENGINE_KW, enable_prefix_cache=False, **MULTI)
    clean = _run_all(ServingEngine(model, device="cpu", **kw), prompts)
    eng = ServingEngine(model, device="cpu", **kw)
    rids = [eng.add_request(p, max_new_tokens=m) for p, m, _ in prompts]
    while not all(eng.requests[r].state is RequestState.DECODE
                  for r in rids):
        eng.step()
    pre = len(eng.requests[rids[1]].output_ids)
    with faults.injected("serving.engine.nan_logits", payload=[1],
                         times=1):
        eng.step()
    eng.run()
    assert eng.metrics.counters["requests_quarantined"] == 1
    bad = eng.requests[rids[1]]
    assert bad.finish_reason == "quarantined"
    assert len(bad.output_ids) == pre
    for i in (0, 2, 3):
        assert eng.requests[rids[i]].output_ids == clean[i]
    assert eng.allocator.num_used == 0


@pytest.mark.parametrize("mode", ["multi_decode", "verify"])
def test_unattributed_poison_rolls_back_and_isolates(models, workload,
                                                     reference_runs, mode):
    """A K-step or a verify launch fails with poison no row is blamed
    for: its extension slots or drafts roll back, every row reruns solo
    through plain decode and is delivered its one token, and the drain
    ends with the reference's tokens, nobody quarantined, every page
    back."""
    extra = (MULTI if mode == "multi_decode" else
             dict(proposer=NgramProposer(), spec_k=4, spec_buckets=[4]))
    eng = ServingEngine(models[1], device="cpu", **ENGINE_KW, **extra)
    with faults.injected(f"serving.engine.{mode}_step",
                         exc=PoisonedComputation("non-finite batch"),
                         after=2, times=1):
        out = _run_all(eng, workload)
    assert out == reference_runs[None]
    c = eng.metrics.counters
    assert c["requests_quarantined"] == 0
    solo = [r for r in eng.timeline()
            if any(p.startswith("decode:") for p in r["programs"])]
    # the failed launch's step, and only it, ran the solo launches
    assert len(solo) == 1
    assert any(p.startswith(mode + ":") for p in solo[0]["programs"])
    if mode == "verify":
        # the failed launch's drafts rolled back; nothing verified
        assert c["spec_rollback_tokens"] > 0
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0
    eng.allocator.check_invariants()


def test_construction_validation(models):
    """The reference's construction rules: the proposer conflict (its
    reason), MAX_DECODE_STEPS, decode_steps >= 1, the K grid's top."""
    model = models[1]
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingEngine(model, device="cpu", decode_steps=4,
                      proposer=NgramProposer(), **ENGINE_KW)
    with pytest.raises(ValueError, match="MAX_DECODE_STEPS"):
        ServingEngine(model, device="cpu",
                      decode_steps=MAX_DECODE_STEPS + 1, **ENGINE_KW)
    with pytest.raises(ValueError, match="decode_steps"):
        ServingEngine(model, device="cpu", decode_steps=0, **ENGINE_KW)
    with pytest.raises(ValueError, match="multi bucket"):
        ServingEngine(model, device="cpu", decode_steps=8,
                      multi_buckets=[2, 4], **ENGINE_KW)
    eng = ServingEngine(model, device="cpu", decode_steps=MAX_DECODE_STEPS,
                        **ENGINE_KW)
    assert eng.multi_buckets[-1] == MAX_DECODE_STEPS
    assert eng.scheduler.decode_token_cost == MAX_DECODE_STEPS


def test_tpot_sample_is_per_token_across_k(models, monkeypatch):
    """The TPOT sample is launch seconds / tokens emitted: with every
    timer read 5 ms apart, a K=1 launch samples 5 ms and a full K=4
    launch 5/4 ms."""
    tick = {"t": 0.0}

    def fake_perf():
        tick["t"] += 0.005
        return tick["t"]

    monkeypatch.setattr(engine_mod, "_perf_counter", fake_perf)
    prompt = np.random.RandomState(3).randint(0, 128, (10,)).tolist()
    samples = {}
    for k in (1, 4):
        eng = ServingEngine(models[1], device="cpu", decode_steps=k,
                            num_pages=64, page_size=8, token_budget=32,
                            batch_buckets=[1], prefill_buckets=[16],
                            pages_buckets=[4])
        eng.add_request(prompt, max_new_tokens=9)
        eng.run()
        samples[k] = list(eng.metrics._reservoirs["tpot"])
        assert len(samples[k]) == eng.metrics.counters["decode_launches"]
    assert samples[1][0] == pytest.approx(0.005)
    assert samples[4][0] == pytest.approx(0.005 / 4)


def test_lora_with_decode_steps_4(models):
    """Multi-LoRA at K=4 (the reference allows the pair): tokens equal
    the K=1 LoRA engine's, launches mix adapters, refs return to 0."""
    model = models[1]
    rng = np.random.RandomState(5)
    names = ["a1", "a2", None]
    work = [(rng.randint(0, 128, (int(n),)).tolist(), int(m), names[i % 3])
            for i, (n, m) in enumerate(zip(rng.randint(4, 20, 6),
                                           rng.randint(3, 10, 6)))]

    def registry():
        reg = AdapterRegistry.for_model(model, rank_buckets=(8,), slots=3,
                                        device="cpu")
        for name, seed in (("a1", 1), ("a2", 2)):
            reg.load(LoRAAdapter.random(name, 4, reg.layout.dims,
                                        seed=seed, scale=0.2))
        return reg

    outs = {}
    for k in (1, 4):
        reg = registry()
        eng = ServingEngine(model, device="cpu", lora=reg, decode_steps=k,
                            **ENGINE_KW)
        rids = [eng.add_request(p, max_new_tokens=m, adapter=a)
                for p, m, a in work]
        out = eng.run()
        outs[k] = [out[r] for r in rids]
        assert all(reg.refs_of(n) == 0 for n in names if n)
        assert eng.metrics.snapshot()["adapter_mix_p50"] > 1
    assert outs[4] == outs[1]


def test_bf16_engines_token_agreement_with_reference(workload, capsys):
    """Not a parity gate: bf16 engines round differently (the reference
    carries rope's fp32 results onward; eager PyTorch and XLA order sums
    differently). The port's bf16 engine and the reference's, K=1 and
    K=4, on the 16 requests: every request completes with its count; the
    line printed (run with -s) gives the requests whose tokens agree and,
    for the first that does not, where and by what logit margin (the
    port's bf16 logits there: its token's minus the reference's)."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    ref, port32 = model_pair(seed=0)
    ref.bfloat16()
    port = LlamaForCausalLM(port32.cfg, device="cpu", dtype=torch.bfloat16)
    port.load_state_dict(port32.state_dict())
    report = {}
    for k in (1, 4):
        kw = dict(ENGINE_KW, **(MULTI if k > 1 else {}))
        got = _run_all(ServingEngine(port, device="cpu", **kw), workload)
        want = _run_all(JaxEngine(ref, **kw), workload)
        assert [len(o) for o in got] == [len(o) for o in want]
        first = next(((i, j) for i, (a, b) in enumerate(zip(got, want))
                      for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        row = {"identical_requests": sum(a == b for a, b in zip(got, want)),
               "requests": len(want)}
        if first is not None:
            i, j = first
            ids = workload[i][0] + want[i][:j]
            with torch.inference_mode():
                lg = port(torch.tensor([ids]))[0, -1].float()
            row.update(request=i, token=j, port_token=got[i][j],
                       reference_token=want[i][j],
                       logit_margin=float(lg[got[i][j]] - lg[want[i][j]]))
        report[f"K{k}"] = row
    with capsys.disabled():
        print("\nbf16 engine agreement:", report)
