"""Token sampling and the preallocated-cache decode loop (port of
`paddle_tpu/models/generation.py`: `_filter_logits`, `_sample_arr`,
`jit_generate`).

Greedy is argmax. With temperature > 0 the draw is Gumbel-max over the
filtered logits, fed with noise the CALLER drew beforehand from an
explicit `torch.Generator` (`sample_noise`) — so a launch that is
retried after a transient failure replays bit-identically. The noise
stream is not JAX's: sampled tokens match the reference in
distribution, not bit for bit. `LlamaForCausalLM.generate` draws one
(B, V) noise block per new token from a generator on the model's device
(`make_generator`), so two runs with one seed give the same tokens, and
so do the eager loop and `jit_generate`.

`jit_generate` is the reference's fixed-size decode: a (B, S0 + N, KVH,
D) buffer per layer allocated once and written in place at each step's
position, with the reference's early exit once every row has emitted
EOS (the generated region is prefilled with EOS, or 0 without one).
The reference compiles the loop into one XLA program; here it is the
same eager loop over the buffer (capturing it in a CUDA graph is not
done).
"""
from __future__ import annotations

import torch

__all__ = ["sample_noise", "make_generator", "next_token",
           "jit_generate", "_filter_logits", "_sample"]


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature + top-k + top-p (nucleus) filtering over the last
    axis; leading axes are batched. Returns float32 filtered logits
    (masked-out entries at -inf)."""
    lg = logits.float() / temperature
    V = lg.shape[-1]
    if top_k and top_k < V:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest logit still inside the nucleus
        keep = (cum - probs) < top_p
        kth = torch.where(keep, sorted_lg,
                          torch.full_like(sorted_lg, float("inf")))
        kth = kth.amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return lg


def sample_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of `shape` from `generator` (float32)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample(logits, temperature, top_k, top_p, noise=None):
    """(B, V) logits -> (B,) int64 token ids. `noise` (Gumbel, (B, V))
    is required when temperature > 0."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if noise is None:
        raise ValueError("sampling at temperature > 0 needs pre-drawn "
                         "noise (sample_noise)")
    lg = _filter_logits(logits, temperature, top_k, top_p)
    return torch.argmax(lg + noise, dim=-1)


def make_generator(seed, device) -> torch.Generator:
    """A generator on `device` seeded with `seed`, or with a draw from
    torch's default generator when seed is None."""
    if seed is None:
        seed = int(torch.randint(0, 2 ** 62, ()).item())
    return torch.Generator(device=device).manual_seed(int(seed))


def next_token(logits, temperature, top_k, top_p, generator):
    """(B, V) logits -> (B,) int64 tokens: greedy, or one (B, V) noise
    block drawn from `generator` when temperature > 0."""
    noise = (sample_noise(tuple(logits.shape), generator, logits.device)
             if temperature > 0.0 else None)
    return _sample(logits, float(temperature), int(top_k), float(top_p),
                   noise)


@torch.no_grad()
def jit_generate(model, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=None):
    """Generate over preallocated caches: `model(ids, caches=...,
    cache_pos=...)` writes each step's K/V in place. Returns (B, S0 +
    max_new_tokens) ids; rows that hit EOS are padded with it. The noise
    comes from a generator on the ids' device seeded with `seed`."""
    ids = torch.as_tensor(input_ids)
    B, S0 = ids.shape
    N = int(max_new_tokens)
    if N <= 0:
        return ids
    gen = make_generator(seed, ids.device)
    caches = model._new_caches(B, S0 + N)
    logits, caches = model(ids, caches=caches, cache_pos=0)
    tok = next_token(logits[:, -1], temperature, top_k, top_p, gen)
    fill = eos_token_id if eos_token_id is not None else 0
    out = torch.cat([ids, torch.full((B, N), fill, dtype=ids.dtype,
                                     device=ids.device)], dim=1)
    out[:, S0] = tok
    done = tok == eos_token_id if eos_token_id is not None else None
    t = 0
    while t < N - 1 and (done is None or not bool(done.all())):
        logits, caches = model(tok[:, None].to(ids.dtype), caches=caches,
                               cache_pos=S0 + t)
        nxt = next_token(logits[:, 0], temperature, top_k, top_p, gen)
        if done is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out[:, S0 + t + 1] = nxt
        tok = nxt
        t += 1
    return out
