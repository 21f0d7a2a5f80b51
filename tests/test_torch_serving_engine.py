"""The PyTorch port's ServingEngine against the reference engine on the
CPU: the same seeded weights (through models/convert.py), the same
staggered requests and a shared-prefix batch that hits the radix cache,
the same pinned single-bucket grid, greedy at fp32. Outputs must be
token-identical and every page reclaimed after reset_prefix_cache().

Both engines run the same launch shapes (one prefill-chunk bucket, one
decode bucket) — the reference only promises identical rounding within
one program shape, so the grid is pinned as in test_serving_engine.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (AdapterRegistry, ServingEngine,
                                      UnsupportedFeature)

from _torch_parity import SMALL, model_pair

ENGINE_KW = dict(num_pages=64, page_size=8, token_budget=48,
                 batch_buckets=[8], prefill_buckets=[64], pages_buckets=[8],
                 temperature=0.0)


def _workload():
    rng = np.random.RandomState(7)
    stagger = [(rng.randint(0, 128, (int(n),)).tolist(), int(m))
               for n, m in zip(rng.randint(3, 30, 5), rng.randint(3, 9, 5))]
    # shared-prefix batch: two pages of the first staggered prompt's
    # prefix, so once it finishes and donates, these hit the radix tree
    base = stagger[0][0]
    while len(base) < 16:
        base = base + base
    shared = [(base[:16] + rng.randint(0, 128, (int(t),)).tolist(), 4)
              for t in (2, 5, 9)]
    return stagger, shared


def _drive(eng):
    """Same add/step schedule on either engine: 3 requests up front, 2
    more once decoding is under way, then the shared-prefix batch after
    the first wave has drained."""
    stagger, shared = _workload()
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in stagger[:3]]
    steps = 0
    while eng.has_work():
        if steps == 2:
            rids += [eng.add_request(p, max_new_tokens=m)
                     for p, m in stagger[3:]]
        eng.step()
        steps += 1
        assert steps < 200
    rids += [eng.add_request(p, max_new_tokens=m) for p, m in shared]
    eng.run()
    return [list(eng.requests[r].output_ids) for r in rids]


@pytest.fixture(scope="module")
def models():
    return model_pair(seed=3)


def test_engine_greedy_token_identical_to_reference(models):
    ref_model, port_model = models
    ref = JaxEngine(ref_model, **ENGINE_KW)
    port = ServingEngine(port_model, device="cpu", **ENGINE_KW)
    ref_out = _drive(ref)
    port_out = _drive(port)
    assert port_out == ref_out
    stagger, shared = _workload()
    for out, (_, m) in zip(port_out, stagger + shared):
        assert len(out) == m
    # the shared-prefix batch really came out of the radix cache
    assert port.metrics.counters["prefix_hits"] >= len(shared)
    assert (port.metrics.counters["prefix_hits"]
            == ref.metrics.counters["prefix_hits"])
    assert (port.metrics.counters["prefill_tokens"]
            == ref.metrics.counters["prefill_tokens"])
    # KV fully reclaimed once the donated prefixes are released
    assert port.allocator.num_used == port.radix.num_cached_pages
    port.reset_prefix_cache()
    assert port.allocator.num_used == 0
    port.allocator.check_invariants()


# the string "registry" stands for a CPU AdapterRegistry for SMALL
@pytest.mark.parametrize("kw", [
    dict(proposer=object(), decode_steps=2),
    dict(proposer=object(), role="prefill"),
    dict(role="decode", compile_cache="/x"),
    dict(wq="int8", kv_dtype="int8", decode_steps=2, compile_cache="/x"),
    dict(lora="registry", proposer=object()),
    dict(host_spill_pages=4, enable_prefix_cache=False),
    dict(host_spill_pages=4, compile_cache="/x"),
    dict(role="prefill", decode_steps=2),
    dict(compile_cache="/nonexistent"),
    dict(trace=True, compile_cache="/nonexistent")])
def test_unported_features_are_refused(models, kw):
    """Quantized serving (tests/test_torch_serving_quant.py), LoRA
    (tests/test_torch_serving_lora.py), multi-step decode, speculative
    decoding and tracing (tests/test_torch_serving_multi.py, _spec.py,
    _snapshot.py), the host spill tier and the prefill role
    (tests/test_torch_serving_spill.py, test_torch_fleet.py) are ported;
    a pair the reference's capability table refuses, or any of them with
    the unported feature (compile_cache), is refused before the model is
    converted. (Tensor parallelism is ported: its refusals are in
    tests/test_torch_serving_tp.py.)"""
    if kw.get("lora") == "registry":
        kw = dict(kw, lora=AdapterRegistry.for_model(models[1],
                                                     device="cpu"))
    with pytest.raises(UnsupportedFeature):
        ServingEngine(models[1], device="cpu", **ENGINE_KW, **kw)
    assert models[1].lm_head.weight is not None


def test_a_mesh_that_is_no_tp_serving_mesh_is_refused(models):
    """mesh takes what serving.tp_serving_mesh returns; anything else is
    a TypeError, raised before the model is converted or split."""
    with pytest.raises(TypeError, match="tp_serving_mesh"):
        ServingEngine(models[1], device="cpu", mesh=object(), wq="int8",
                      **ENGINE_KW)
    assert models[1].lm_head.weight is not None
    assert models[1].mesh is None


def test_lora_of_the_wrong_type_is_refused(models):
    """lora takes an AdapterRegistry; anything else is a TypeError, raised
    before the model is converted."""
    with pytest.raises(TypeError, match="AdapterRegistry"):
        ServingEngine(models[1], device="cpu", lora=object(), wq="int8",
                      **ENGINE_KW)
    assert models[1].lm_head.weight is not None


def test_device_defaults_to_the_card():
    """No device argument means CUDA; without a card that raises instead
    of silently running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    cfg = LlamaConfig(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg)
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cpu_model, **ENGINE_KW)


# ---------------------------------------------------------------------
# resilience paths of the ported engine (port only, CPU)

def _port_run(model, faults_armed=(), policy=None, **kw):
    from paddle_tpu_torch.utils import faults
    stagger, _ = _workload()
    eng = ServingEngine(model, device="cpu", retry_policy=policy,
                        **dict(ENGINE_KW, **kw))
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in stagger]
    specs = [(name, faults.inject(name, **spec))
             for name, spec in faults_armed]
    try:
        eng.run()
    finally:
        for name, _ in specs:
            faults.clear(name)
    return eng, rids


def test_transient_decode_faults_retry_bit_identically(models):
    from paddle_tpu_torch.serving import RetryPolicy, TransientDeviceError
    clean, rids = _port_run(models[1])
    want = [clean.requests[r].output_ids for r in rids]
    eng, rids = _port_run(
        models[1], policy=RetryPolicy(sleep=lambda s: None),
        faults_armed=[("serving.engine.decode_step",
                       dict(exc=TransientDeviceError("UNAVAILABLE"),
                            times=3, after=2))])
    assert [eng.requests[r].output_ids for r in rids] == want
    assert eng.metrics.counters["step_retries"] == 3


def test_nan_logits_quarantine_only_the_poisoned_request(models):
    clean, rids = _port_run(models[1])
    eng, rids2 = _port_run(
        models[1], faults_armed=[("serving.engine.nan_logits",
                                  dict(payload=[0], times=1, after=3))])
    states = [eng.requests[r].finish_reason for r in rids2]
    assert states.count("quarantined") == 1
    for r, r2 in zip(rids, rids2):
        if eng.requests[r2].finish_reason != "quarantined":
            assert eng.requests[r2].output_ids == \
                clean.requests[r].output_ids
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0


def test_fatal_launch_error_fails_the_engine(models):
    from paddle_tpu_torch.serving import EngineFailure
    from paddle_tpu_torch.utils import faults
    eng = ServingEngine(models[1], device="cpu", **ENGINE_KW)
    eng.add_request([1, 2, 3], max_new_tokens=4)
    with faults.injected("serving.engine.prefill_chunk",
                         exc=RuntimeError("CUDA error: an illegal memory "
                                          "access was encountered")):
        with pytest.raises(EngineFailure):
            eng.step()
    assert eng.failed
    with pytest.raises(EngineFailure):
        eng.step()


def test_abort_and_deadline_cancel_at_the_boundary(models):
    now = [0.0]
    eng = ServingEngine(models[1], device="cpu", clock=lambda: now[0],
                        **ENGINE_KW)
    a = eng.add_request(list(range(20)), max_new_tokens=8)
    b = eng.add_request(list(range(5, 30)), max_new_tokens=8, ttl_s=5.0)
    c = eng.add_request(list(range(9)), max_new_tokens=3)
    eng.step()
    eng.step()
    assert eng.abort(a)
    now[0] = 10.0
    eng.run()
    assert eng.requests[a].finish_reason == "abort"
    assert eng.requests[b].finish_reason == "expired"
    assert len(eng.requests[c].output_ids) == 3
    assert not eng.abort(c)                    # already finished
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0


# ---------------------------------------------------------------------
# host-side scheduling: the port's allocator / radix cache / scheduler
# against the reference's, step by step, with no model

def _schedule_trace(kv_cache, radix_cache, scheduler, prompts):
    alloc = kv_cache.BlockAllocator(16, 8)
    radix = radix_cache.RadixCache(alloc)
    sched = scheduler.Scheduler(alloc, max_batch_size=4, token_budget=40,
                                prefix_cache=radix)
    reqs = []
    index = {}
    trace = []
    for step in range(400):
        if step % 3 == 0 and len(reqs) < len(prompts):
            p, m = prompts[len(reqs)]
            r = scheduler.Request(p, m)
            index[r.request_id] = len(reqs)
            reqs.append(r)
            sched.add_request(r)
        if not sched.has_work() and len(reqs) == len(prompts):
            break
        s = sched.schedule()
        trace.append((
            [(index[c.request_id], c.start, c.length, c.is_last)
             for c in s.prefills],
            [index[r.request_id] for r in s.decodes],
            [index[r.request_id] for r in s.preempted],
            list(alloc._free)))
        for c in s.prefills:
            r = c.request
            r.num_computed = c.start + c.length
            if c.is_last:
                r.output_ids.append((index[r.request_id] * 7 + 1) % 50)
                if r.remaining_new_tokens() <= 0:
                    sched.finish(r, "length")
                else:
                    sched.on_prefilled(r)
        for r in s.decodes:
            r.num_computed = r.seq.num_tokens
            r.output_ids.append((index[r.request_id] + len(r.output_ids))
                                % 50)
            if r.remaining_new_tokens() <= 0:
                sched.finish(r, "length")
    alloc.check_invariants()
    radix.check_invariants()
    return trace, [r.output_ids for r in reqs]


def test_scheduling_trace_matches_reference():
    """A pool of 15 pages under 10 requests sharing prefixes forces
    radix hits, LRU eviction and preemption; every step's chunks, decode
    batch, preemptions and free list must match the reference."""
    from paddle_tpu.serving import kv_cache as r_kv
    from paddle_tpu.serving import radix_cache as r_radix
    from paddle_tpu.serving import scheduler as r_sched
    from paddle_tpu_torch.serving import kv_cache as p_kv
    from paddle_tpu_torch.serving import radix_cache as p_radix
    from paddle_tpu_torch.serving import scheduler as p_sched
    rng = np.random.RandomState(11)
    base = rng.randint(0, 50, 24).tolist()
    prompts = []
    for i in range(10):
        head = base[:8 * (i % 3)] if i % 2 == 0 else []
        tail = rng.randint(0, 50, int(rng.randint(3, 30))).tolist()
        prompts.append((head + tail, int(rng.randint(10, 30))))
    ref = _schedule_trace(r_kv, r_radix, r_sched, prompts)
    port = _schedule_trace(p_kv, p_radix, p_sched, prompts)
    assert port == ref
    assert any(step[2] for step in ref[0])       # preemption happened
