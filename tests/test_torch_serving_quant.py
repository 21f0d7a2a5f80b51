"""The port's quantized serving against the reference engine on the CPU:
`kv_dtype="int8"` (int8 KV pages with fp32 per-slot scales),
`wq="int8"` with `kv_dtype="int8"` (plus int8 MLP and LM-head weights)
and `wq="int4"`. The same seeded weights (through models/convert.py),
the same staggered requests and shared-prefix batch (radix hits), the
same pinned single-bucket grid, greedy at fp32: tokens, the per-step
free list and the page counts must be identical, and every page
reclaimed after reset_prefix_cache().

Each configuration drains the reference engine once, in a module-scoped
fixture (three drains in all), since a drain costs seconds on the CPU.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models.convert import from_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.quant import WeightOnlyLinear, quantize_for_serving
from paddle_tpu_torch.serving import ServingEngine

from _torch_parity import SMALL, model_pair

ENGINE_KW = dict(num_pages=64, page_size=8, token_budget=48,
                 batch_buckets=[8], prefill_buckets=[64], pages_buckets=[8],
                 temperature=0.0)
CONFIGS = {"kv8": dict(kv_dtype="int8"),
           "wq8_kv8": dict(wq="int8", kv_dtype="int8"),
           "wq4": dict(wq="int4")}


def _workload():
    """Five staggered requests (the even ones over a shared two-page
    head), then three more over the head once those have finished and
    donated their pages, so they hit the radix cache."""
    rng = np.random.RandomState(21)
    head = rng.randint(0, 128, (16,)).tolist()
    work = []
    for i in range(8):
        tail = rng.randint(0, 128, (int(rng.randint(2, 20)),)).tolist()
        work.append(((head + tail) if i % 2 == 0 or i >= 5 else tail,
                     int(rng.randint(3, 9))))
    return work


def _drive(eng):
    """3 requests up front, 2 more once decoding is under way, the last 3
    after the engine drained. Returns (outputs, per-step (emitted, free
    list, used pages))."""
    work = _workload()
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in work[:3]]
    trace = []
    while True:
        if len(trace) == 3:
            rids += [eng.add_request(p, max_new_tokens=m)
                     for p, m in work[3:5]]
        if not eng.has_work():
            if len(rids) == len(work):
                break
            rids += [eng.add_request(p, max_new_tokens=m)
                     for p, m in work[5:]]
        index = {r: i for i, r in enumerate(rids)}
        emitted = [(index[r], int(t)) for r, t in eng.step()]
        trace.append((emitted, list(eng.allocator._free),
                      eng.allocator.num_used))
        assert len(trace) < 300
    return [list(eng.requests[r].output_ids) for r in rids], trace


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request):
    kw = CONFIGS[request.param]
    ref_model, port_model = model_pair(seed=9)
    ref = JaxEngine(ref_model, **ENGINE_KW, **kw)
    port = ServingEngine(port_model, device="cpu", **ENGINE_KW, **kw)
    ref_out, ref_trace = _drive(ref)
    port_out, port_trace = _drive(port)
    yield dict(name=request.param, kw=kw, ref=ref, port=port,
               ref_model=ref_model, port_model=port_model,
               out=(ref_out, port_out), trace=(ref_trace, port_trace))
    ref.shutdown()


def test_quantized_engine_token_identical_to_reference(run):
    ref_out, port_out = run["out"]
    assert port_out == ref_out
    assert [len(o) for o in port_out] == [m for _, m in _workload()]
    port, ref = run["port"], run["ref"]
    assert port.metrics.counters["prefix_hits"] >= 3
    for key in ("prefix_hits", "prefill_tokens", "decode_launches"):
        assert port.metrics.counters[key] == ref.metrics.counters[key], key


def test_quantized_paging_trace_identical_to_reference(run):
    """Every step emits the same tokens and leaves the same free list
    and used-page count; everything is reclaimed at the end."""
    ref_trace, port_trace = run["trace"]
    assert port_trace == ref_trace
    port = run["port"]
    port.reset_prefix_cache()
    assert port.allocator.num_used == 0
    port.allocator.check_invariants()


def test_quantized_engine_state_matches_reference(run):
    port, ref = run["port"], run["ref"]
    assert port.num_wq_layers == ref.num_wq_layers \
        == (7 if "wq" in run["kw"] else 0)
    assert port.kv_page_bytes == ref.kv_page_bytes
    assert port.kv_bytes_per_token == ref.kv_bytes_per_token
    want, got = ref.metrics.snapshot(), port.metrics.snapshot()
    for key in ("kv_dtype", "kv_page_bytes", "kv_pool_bytes",
                "kv_bytes_per_token", "kv_bytes_written", "kv_bytes_read"):
        assert got[key] == want[key], key
    layer = port.kv_caches[0]
    if run["kw"].get("kv_dtype") == "int8":
        assert [t.dtype for t in layer] == [torch.int8, torch.int8,
                                            torch.float32, torch.float32]
        assert tuple(layer[2].shape) == tuple(layer[0].shape[:3])
    else:
        assert [t.dtype for t in layer] == [torch.float32] * 2


def test_weights_cross_as_the_engine_left_them(run):
    """The reference model after its engine (converted in place when wq
    is set: int8 `qweight` + fp32 `weight_scale` buffers) crosses through
    `from_jax_state_dict(…, wq=)` strictly into a port model converted
    the same way, and equals the port engine's model bitwise."""
    wq = run["kw"].get("wq")
    cfg = LlamaConfig(**SMALL)
    exported = {k: np.array(v._data)
                for k, v in run["ref_model"].state_dict().items()}
    fresh = LlamaForCausalLM(cfg, device="cpu")
    if wq is not None:
        assert quantize_for_serving(fresh, algo=f"weight_only_{wq}") == 7
        assert isinstance(fresh.lm_head, WeightOnlyLinear)
        with pytest.raises(ValueError, match="missing"):
            from_jax_state_dict(exported, cfg)      # wq not named
    fresh.load_state_dict(from_jax_state_dict(exported, cfg, wq=wq),
                          strict=True)
    mine = run["port_model"].state_dict()
    assert sorted(fresh.state_dict()) == sorted(mine)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, mine[k]), k


def test_kv_pool_bytes_gives_reference_page_count():
    """The pool sizing at a fixed byte budget: int8 pages cost
    2 * KVH * page * (D + 4) bytes, fp32 ones 2 * KVH * page * D * 4."""
    ref_model, port_model = model_pair(seed=9)
    pool = 64 * 1024
    pages = {}
    for kvd in (None, "int8"):
        kw = dict(ENGINE_KW, kv_pool_bytes=pool, kv_dtype=kvd)
        ref = JaxEngine(ref_model, **kw)
        port = ServingEngine(port_model, device="cpu", **kw)
        assert port.num_pages == ref.num_pages
        assert port.metrics.snapshot()["kv_pool_bytes"] == \
            ref.metrics.snapshot()["kv_pool_bytes"]
        pages[kvd] = port.num_pages
        ref.shutdown()
    assert pages == {None: pool // (2 * 1 * 8 * 64 * 4),
                     "int8": pool // (2 * 1 * 8 * (64 + 4))}


@pytest.mark.parametrize("kw", [dict(kv_dtype="int4"), dict(kv_dtype="fp8"),
                                dict(wq="fp8"), dict(wq="int2")])
def test_invalid_quant_configs_raise_like_reference(kw):
    ref_model, port_model = model_pair(seed=9)
    with pytest.raises(ValueError) as want:
        JaxEngine(ref_model, **ENGINE_KW, **kw)
    with pytest.raises(ValueError) as got:
        ServingEngine(port_model, device="cpu", **ENGINE_KW, **kw)
    assert str(got.value) == str(want.value)


def test_cow_copy_carries_scale_rows():
    """A copy-on-write page copy under int8 copies the per-slot scale
    rows with the values: a fork that kept the destination's scales
    would dequantize the copied page wrongly."""
    _, port_model = model_pair(seed=9)
    eng = ServingEngine(port_model, device="cpu", kv_dtype="int8",
                        **ENGINE_KW)
    src, dst = 3, 5
    for i, (k, v, ks, vs) in enumerate(eng.kv_caches):
        k[src] = i + 1
        v[src] = -(i + 1)
        ks[src] = 0.5 * (i + 1)
        vs[src] = 0.25 * (i + 1)
    eng._apply_copies([(src, dst)])
    for i, (k, v, ks, vs) in enumerate(eng.kv_caches):
        assert (k[dst] == i + 1).all() and (v[dst] == -(i + 1)).all()
        assert (ks[dst] == 0.5 * (i + 1)).all()
        assert (vs[dst] == 0.25 * (i + 1)).all()
