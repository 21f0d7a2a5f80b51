"""Shared helper of the `test_torch_*` parity tests: one set of seeded
numpy weights goes into the reference (JAX) model, is exported back from
its state dict and crosses into the PyTorch port through
`paddle_tpu_torch.models.convert`, so both frameworks hold identical
parameters. Weights always cross as arrays: the two frameworks' random
initializers never agree."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models.convert import (expected_shapes,
                                             from_jax_state_dict)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

# head_dim 64 (the paged kernels need a multiple of 64), G = 2
SMALL = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, max_position_embeddings=128)


def seeded_state(cfg: LlamaConfig, seed: int = 0):
    """Seeded fp32 weights for every parameter of `cfg`: matrices scaled
    by 1/sqrt(fan_in), norm weights near 1 (so the weight multiply of
    RMSNorm is exercised)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in expected_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            out[name] = (rng.randn(*shape)
                         / np.sqrt(shape[0])).astype(np.float32)
    return out


def model_pair(seed: int = 0, **overrides):
    """(reference model, port model on the CPU) with identical fp32
    weights."""
    kw = dict(SMALL, **overrides)
    paddle.seed(seed)
    ref = JaxLlama(JaxLlamaConfig(**kw))
    cfg = LlamaConfig(**kw)
    missing, unexpected = ref.set_state_dict(seeded_state(cfg, seed))
    assert not missing and not unexpected
    exported = {k: np.asarray(v._data) for k, v in ref.state_dict().items()}
    port = LlamaForCausalLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    port.load_state_dict(from_jax_state_dict(exported, cfg), strict=True)
    return ref, port


def counting_clock():
    """A tracer clock that returns 0, 1, 2, ... per call: two engines
    whose tracers read it in the same order stamp the same values."""
    return iter(range(10 ** 9)).__next__


def trace_view(tracer):
    """Every trace of `tracer`, in request-id order, with the engine
    names dropped (the two engines' metrics names differ by
    construction): meta, begin/end stamps, finish reason, and the spans
    and marks in order by name, stamps and arguments."""
    def args(a):
        return {k: v for k, v in a.items() if k != "engine"}

    return [{"meta": args(tr.meta), "t": (tr.t_begin, tr.t_end),
             "finish": tr.finish_reason,
             "spans": [(s["name"], s["t0"], s["t1"], args(s["args"]))
                       for s in tr.spans],
             "marks": [(m["name"], m["t"], args(m["args"]))
                       for m in tr.marks]}
            for tr in sorted(tracer.traces(), key=lambda t: t.request_id)]


def assert_traces_equal(port, ref, spans=(), marks=()):
    """Two `trace_view`s are equal request by request, and the port's
    holds at least the named spans and marks."""
    assert len(port) == len(ref) and ref
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, i
    assert {s[0] for v in port for s in v["spans"]} >= set(spans)
    assert {m[0] for v in port for m in v["marks"]} >= set(marks)
