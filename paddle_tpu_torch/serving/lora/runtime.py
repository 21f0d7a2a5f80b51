"""LoRA threading through a launch: scope, paged gather, delta (port of
`paddle_tpu/serving/lora/runtime.py`).

The engine takes the registry's `flat_args()` (pools, page tables,
scales, all on the card) and the launch's per-row slot ids, builds a
`LoRAContext` from them once per launch (`build_context`), and enters
`lora_scope(ctx)` around the model call. The model's projection hooks
(`apply_lora`, called from models/llama.py) read the ambient scope: with
none active they return the projection output itself, at the cost of
one thread-local read per projection, so training and lora-less serving
run exactly what they ran before.

Paged gather: for each rank bucket, the slot stacks A (S, H, R) and
B (S, R, N) come from the pools by `pool[page_table]`. Quantized slots
dequantize during the gather (per-column scales) and the two pools SUM:
an adapter lives in exactly one pool, the other's table rows hold the
all-zero PAD page, so the sum adds an exact 0.0. The per-slot alpha/rank
scaling folds into B once, here. All in fp32, in the reference's order
of operations, so the stacks are the reference's bits on the CPU.

Delta dispatch: one call of `kernels/lora_matmul.lora_apply` per
projection (`LoRAContext.apply`), every rank bucket at once; rows whose
slot lies outside a bucket take its null slot 0 (an exact zero), the
buckets' deltas sum in fp32, and the sum is cast to y's dtype and added.
On CUDA tensors every call, decode rows and prefill chunks alike, is one
launch of the LoRA kernel, epilogue included, or raises. On CPU tensors
the plain version follows the reference's dispatch: single-token rows on
a shape its tiling rule supports take the plain version of its kernel,
everything else its gathered composition.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from ...kernels.lora_matmul import LoRABuckets, lora_apply

__all__ = ["lora_scope", "current_lora", "apply_lora", "LoRAContext",
           "build_context"]

_ACTIVE = threading.local()


def current_lora():
    """The active LoRAContext, or None (the one check the default path
    pays)."""
    return getattr(_ACTIVE, "ctx", None)


@contextmanager
def lora_scope(ctx):
    prev = getattr(_ACTIVE, "ctx", None)
    _ACTIVE.ctx = ctx
    try:
        yield ctx
    finally:
        _ACTIVE.ctx = prev


class LoRAContext:
    """One launch's adapter view: per-bucket per-module (A, B) stacks (B
    pre-scaled) and the per-row global slot ids."""

    def __init__(self, layout, stacks, row_slots):
        self.layout = layout
        self.stacks = stacks          # {bucket: {module: (A, B)}}
        self.row_slots = row_slots    # (B,) int32 global slot ids
        self._buckets = {}            # module -> LoRABuckets

    def buckets(self, module: str) -> LoRABuckets:
        """The module's rank buckets as `lora_apply` takes them: bucket bi
        holds global slots bi * slots ... Every layer of a launch asks the
        same, so they are checked and packed once."""
        packed = self._buckets.get(module)
        if packed is None:
            packed = LoRABuckets(
                [self.stacks[r][module] + (bi * self.layout.slots,)
                 for bi, r in enumerate(self.layout.rank_buckets)])
            self._buckets[module] = packed
        return packed

    def delta(self, module, x):
        """(b, t, h) x -> (b, t, out) fp32 delta, summed over the rank
        buckets (a row lives in exactly one; the others give exact 0)."""
        b, t, h = x.shape
        return lora_apply(x.reshape(b * t, h).contiguous(), None,
                          self.row_slots, self.buckets(module)
                          ).reshape(b, t, -1)

    def apply(self, module, x, y):
        """y + delta(module, x).to(y.dtype) for the projection input x (b,
        t, h) and its output y (b, t, out). On the card the kernel writes
        the sum into y itself when autograd is off (y is the projection's
        fresh output); with autograd on and y requiring grad, the delta
        is added out of place so y's graph stays."""
        b, t, h = x.shape
        x2 = x.reshape(b * t, h).contiguous()
        if not y.is_cuda:
            return lora_apply(x2, y.reshape(b * t, -1), self.row_slots,
                              self.buckets(module)).reshape(y.shape)
        if torch.is_grad_enabled() and y.requires_grad:
            return y + self.delta(module, x).to(y.dtype)
        y2 = y.reshape(b * t, -1).contiguous()
        return lora_apply(x2, y2, self.row_slots, self.buckets(module),
                          out=y2).reshape(y.shape)


def build_context(layout, flat_args, row_slots):
    """A registry `flat_args()` tuple and per-row slot ids -> LoRAContext:
    gather every bucket's slot payloads from the paged pools, slice and
    reshape per module, dequantize int8 slots, fold the per-slot scaling
    into B."""
    pool_f, pool_q = flat_args[0], flat_args[1]
    stacks = {}
    idx = 2
    for r in layout.rank_buckets:
        table_f, table_q, scales, scaling = flat_args[idx:idx + 4]
        idx += 4
        # (slots, pages, page_elems) -> (slots, pages * page_elems): the
        # flat payload view _pack wrote, PAD rows exact zeros
        pay_f = pool_f[table_f.long()].reshape(layout.slots, -1)
        pay_q = pool_q[table_q.long()].reshape(layout.slots, -1)
        per_mod = {}
        for m, (di, do) in layout.dims.items():
            a0, a1 = layout.offsets[r][m]
            b0, b1 = layout.offsets[r][m + "#B"]
            s0, s1 = layout.scale_offsets[r][m]
            t0, t1 = layout.scale_offsets[r][m + "#B"]
            a_f = pay_f[:, a0:a1].reshape(layout.slots, di, r)
            b_f = pay_f[:, b0:b1].reshape(layout.slots, r, do)
            a_q = pay_q[:, a0:a1].reshape(layout.slots, di, r).float() \
                * scales[:, s0:s1][:, None, :]
            b_q = pay_q[:, b0:b1].reshape(layout.slots, r, do).float() \
                * scales[:, t0:t1][:, None, :]
            a = a_f + a_q                       # one pool is exact zeros
            bmat = (b_f + b_q) * scaling[:, None, None]
            per_mod[m] = (a, bmat)
        stacks[r] = per_mod
    return LoRAContext(layout, stacks, row_slots)


def apply_lora(module: str, x, y):
    """Projection hook (called from models/llama.py): y + delta when a
    scope is active and targets `module`; y itself otherwise. x is the
    projection's input, y its output."""
    ctx = current_lora()
    if ctx is None or module not in ctx.layout.dims:
        return y
    return ctx.apply(module, x, y)
