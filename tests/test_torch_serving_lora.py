"""The port's multi-LoRA serving against the reference engine on the CPU.

The reference test's 16-request mixed workload (tests/test_serving_lora.py:
three adapters plus base rows, shared per-adapter prefixes that produce
radix hits) goes through the JAX engine and the port's with the same
seeded weights (through models/convert.py), the same adapters (the same
seeds), the same pinned buckets, greedy at fp32: tokens must be
identical, prefix hits equal, and launches must really mix adapters. The
rest holds the port to the reference's contracts: solo-vs-mixed
identity, radix isolation between adapters and across a reload, an int8
adapter against its fp32 twin, and the typed failures.

The reference engine drains once, in a module fixture, since a drain
costs seconds on the CPU.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import AdapterRegistry as JaxRegistry
from paddle_tpu.serving import LoRAAdapter as JaxAdapter
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models.convert import from_jax_adapter
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.serving import (AdapterBusy, AdapterLoadError,
                                      AdapterNotLoaded, AdapterRegistry,
                                      ServingEngine)
from paddle_tpu_torch.serving.lora import llama_lora_dims
from paddle_tpu_torch.serving.lora.runtime import build_context
from paddle_tpu_torch.utils import faults

from _torch_parity import SMALL, model_pair

DIMS = llama_lora_dims(LlamaConfig(**SMALL))
# the reference test's single-bucket grid: identity comparisons hit
# identical launch shapes
ENGINE_KW = dict(num_pages=64, page_size=8, token_budget=48,
                 batch_buckets=[8], prefill_buckets=[8, 16, 32],
                 pages_buckets=[2, 4, 8], temperature=0.0)


def _jax_adapter(name, rank=4):
    """Name-deterministic weights (the reference test's seeds)."""
    return JaxAdapter.random(name, rank, DIMS, seed=100 + sum(map(ord, name)))


def _registry(names=("a1", "a2", "a3"), quant=(), jax=False, **kw):
    kw.setdefault("rank_buckets", (8,))
    kw.setdefault("slots", 4)
    reg = JaxRegistry(DIMS, **kw) if jax else \
        AdapterRegistry(DIMS, device="cpu", **kw)
    for n in names:
        ad = _jax_adapter(n)
        reg.load(ad if jax else from_jax_adapter(ad),
                 quant="int8" if n in quant else None)
    return reg


def _mixed_workload(n=16, seed=7):
    """The reference test's workload: 3 adapters + base rows; even
    requests share a per-adapter head, interleaved through the arrival
    order, so later same-adapter admissions hit donated pages."""
    rng = np.random.RandomState(seed)
    adapters = ["a1", "a2", "a3", None]
    heads = {a: rng.randint(0, 128, (16,)).tolist() for a in adapters}
    work = []
    for i in range(n):
        a = adapters[i % len(adapters)]
        p = heads[a] + rng.randint(0, 128, (rng.randint(2, 8),)).tolist() \
            if i % 2 == 0 else \
            rng.randint(0, 128, (rng.randint(4, 20),)).tolist()
        work.append((p, int(rng.randint(3, 10)), a))
    return work


def _run(eng, work):
    rids = [eng.add_request(p, max_new_tokens=m, adapter=a)
            for p, m, a in work]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def ref():
    """Both models, and the reference engine's outputs and counters for
    the mixed workload."""
    ref_model, port_model = model_pair(seed=0)
    mixed = JaxEngine(ref_model, lora=_registry(jax=True), **ENGINE_KW)
    out = _run(mixed, _mixed_workload())
    res = dict(port_model=port_model, mixed=out,
               counters=dict(mixed.metrics.counters))
    mixed.shutdown()
    return res


@pytest.fixture(scope="module")
def mixed(ref):
    eng = ServingEngine(ref["port_model"], device="cpu", lora=_registry(),
                        **ENGINE_KW)
    return eng, _run(eng, _mixed_workload())


def test_mixed_workload_tokens_identical_to_reference(ref, mixed):
    eng, out = mixed
    assert out == ref["mixed"]
    c = eng.metrics.counters
    assert c["prefix_hits"] == ref["counters"]["prefix_hits"] > 0
    assert c["prefill_tokens"] == ref["counters"]["prefill_tokens"]
    assert eng.metrics.snapshot()["adapter_mix_p90"] >= 2
    for name in ("a1", "a2", "a3"):
        assert eng.lora.refs_of(name) == 0
    eng.lora.check_invariants()
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0


def test_solo_engines_give_the_mixed_engine_tokens(ref, mixed):
    """Each adapter's rows from the mixed engine == an engine holding
    only that adapter; base rows == a lora engine with no adapter'd
    traffic, and == an engine without lora at all."""
    _, out = mixed
    work = _mixed_workload()
    for name in ("a1", "a2", "a3", None):
        solo = ServingEngine(ref["port_model"], device="cpu",
                             lora=_registry((name,) if name else ("a1",)),
                             **ENGINE_KW)
        sub = [w for w in work if w[2] == name]
        want = [o for o, w in zip(out, work) if w[2] == name]
        assert _run(solo, sub) == want, name
        if name is None:
            plain = ServingEngine(ref["port_model"], device="cpu",
                                  **ENGINE_KW)
            assert _run(plain, sub) == want


def test_radix_never_crosses_adapters_or_reloads(ref):
    """Identical prompts under different adapters (or none) miss the
    radix cache; under the same adapter they hit; a reload under the
    same name misses and serves the new weights."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, 128, (24,)).tolist()     # 3 full pages
    eng = ServingEngine(ref["port_model"], device="cpu",
                        lora=_registry(("a1", "a2")), **ENGINE_KW)
    cached = []
    for adapter in ("a1", "a2", "a1", None):
        rid = eng.add_request(prompt, max_new_tokens=3, adapter=adapter)
        eng.run()
        cached.append(eng.requests[rid].cached_tokens)
    assert cached[0] == cached[1] == cached[3] == 0 and cached[2] > 0
    old = eng.requests[rid - 1].output_ids
    eng.load_adapter(from_jax_adapter(JaxAdapter.random(
        "a1", 4, DIMS, seed=999, scale=0.2)))
    rid = eng.add_request(prompt, max_new_tokens=3, adapter="a1")
    eng.run()
    assert eng.requests[rid].cached_tokens == 0
    assert eng.requests[rid].output_ids != old
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0
    eng.allocator.check_invariants()


def test_int8_adapter_against_its_fp32_twin(ref):
    """An int8 adapter serves every token through the same paged path as
    its fp32 twin (the reference test's check), and its gathered stacks
    are the twin's within the int8 rounding: half a scale step."""
    work = [w for w in _mixed_workload(8) if w[2] == "a1"]
    regs = {q: _registry(("a1",), q) for q in ((), ("a1",))}
    outs = {q: _run(ServingEngine(ref["port_model"], device="cpu", lora=reg,
                                  **ENGINE_KW), work)
            for q, reg in regs.items()}
    assert [len(o) for o in outs[("a1",)]] == [len(o) for o in outs[()]] \
        == [m for _, m, _ in work]
    slot = torch.tensor([regs[()].slot_of("a1")], dtype=torch.int32)
    fp, q8 = (build_context(reg.layout, reg.flat_args(), slot).stacks[8]
              for reg in (regs[()], regs[("a1",)]))
    assert regs[("a1",)].entries["a1"].quant == "int8"
    for m in DIMS:
        for want, got in zip(fp[m], q8[m]):
            step = want.abs().amax(dim=-2, keepdim=True) / 127.0
            assert torch.all((got - want).abs() <= step / 2 + 1e-7), m


def test_typed_failures(ref):
    """Unknown adapters shed typed at the door (counted); a pinned
    adapter refuses to unload until its request finishes; the injected
    load failure sheds typed and leaves the registry as it was."""
    eng = ServingEngine(ref["port_model"], device="cpu",
                        lora=_registry(("a1",)), **ENGINE_KW)
    with pytest.raises(AdapterNotLoaded):
        eng.add_request([1, 2, 3], max_new_tokens=2, adapter="zz")
    assert eng.metrics.counters["adapter_rejects"] == 1
    rid = eng.add_request([1, 2, 3, 4], max_new_tokens=4, adapter="a1")
    assert eng.lora.refs_of("a1") == 1
    with pytest.raises(AdapterBusy):
        eng.unload_adapter("a1")
    eng.run()
    assert eng.lora.refs_of("a1") == 0
    assert len(eng.requests[rid].output_ids) == 4
    with faults.injected("serving.lora.load_fail", payload=True):
        with pytest.raises(AdapterLoadError):
            eng.load_adapter(from_jax_adapter(_jax_adapter("a2")))
    assert eng.metrics.counters["adapter_load_failures"] == 1
    assert eng.lora.has("a1") and not eng.lora.has("a2")
    eng.unload_adapter("a1")
    assert eng.metrics.counters["adapters_unloaded"] == 1
    with pytest.raises(AdapterNotLoaded):
        eng.add_request([1, 2, 3], max_new_tokens=2, adapter="a1")
    plain = ServingEngine(ref["port_model"], device="cpu", **ENGINE_KW)
    with pytest.raises(AdapterNotLoaded):
        plain.add_request([1, 2, 3], max_new_tokens=2, adapter="a1")
    eng.lora.check_invariants()


def test_registry_must_live_on_the_engine_device(ref):
    reg = AdapterRegistry(DIMS, device="meta", slots=2)
    with pytest.raises(ValueError, match="device"):
        ServingEngine(ref["port_model"], device="cpu", lora=reg,
                      **ENGINE_KW)
    with pytest.raises(TypeError, match="AdapterRegistry"):
        ServingEngine(ref["port_model"], device="cpu", lora={"a1": 1},
                      **ENGINE_KW)
    assert torch.device(reg.device).type == "meta"
