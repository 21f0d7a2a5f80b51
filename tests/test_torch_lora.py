"""The port's multi-LoRA pieces against the reference on the CPU: the
delta's plain versions (`lora_matmul_ref`, `lora_matmul_gathered`, the
shrink/expand split), `lora_apply`'s plain version against the
reference's projection hook, the kernel's grouping rule and grid plan,
the tiling rule the CPU dispatch keeps, the adapter registry and the
launch context.

The delta is held against the reference's Pallas kernel, run in
interpret mode off the TPU (as tests/test_lora_matmul.py runs it),
within 1e-5 of the largest |ref|: the two sum in different orders; the
hook's output within one ulp of y's dtype (the delta's last bits may
round the other way). Registry state, `flat_args()` and the gathered
stacks are held bitwise. The CUDA kernel runs only on the card:
tests/test_torch_cuda.py holds it against these plain versions there.
"""
import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import lora_matmul as ref_lm
from paddle_tpu.serving.lora import adapter as ref_adapter
from paddle_tpu.serving.lora import runtime as ref_rt
from paddle_tpu.serving.lora import store as ref_store
from paddle_tpu.utils import faults as ref_faults
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.kernels import lora_matmul as lm
from paddle_tpu_torch.models.convert import from_jax_adapter
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.serving.lora import (AdapterBusy, AdapterLoadError,
                                          AdapterRegistry, LoRAAdapter,
                                          apply_lora, current_lora,
                                          llama_lora_dims, lora_scope)
from paddle_tpu_torch.serving.lora.runtime import build_context
from paddle_tpu_torch.utils import faults

from _torch_parity import SMALL

DIMS = llama_lora_dims(LlamaConfig(**SMALL))


def _np(a):
    return np.array(a)


def _mats(B, H, R, N, S, seed=0):
    """Seeded x (B, H), ids (B,), A (S, H, R), Bs (S, R, N) as numpy,
    slot 0 all zeros (the null adapter)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H).astype(np.float32)
    a = (rng.randn(S, H, R) * 0.02).astype(np.float32)
    b = (rng.randn(S, R, N) * 0.02).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    ids = rng.randint(0, S, (B,)).astype(np.int32)
    return x, ids, a, b


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = rel * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


# -------------------------------------------------------------- the delta
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_ref_matches_reference_kernel(dtype):
    """(B 8, H 256, R 8, N 128, S 4): the port's plain version of the TPU
    kernel against that kernel in interpret mode, bf16 x included (the
    same bf16 values on both sides)."""
    x, ids, a, b = _mats(8, 256, 8, 128, 4)
    xt, idt, at, bt = _torch(x, ids, a, b)
    if dtype == "bfloat16":
        xt = xt.bfloat16()
        x = xt.float().numpy()
    want = ref_lm.lora_matmul(jnp.asarray(x).astype(dtype), jnp.asarray(ids),
                              jnp.asarray(a), jnp.asarray(b))
    got = lm.lora_matmul(xt, idt, at, bt)         # a CPU tensor: the ref
    assert got.dtype == torch.float32
    _close(got.numpy(), _np(want))
    _close(lm.lora_matmul_ref(xt, idt, at, bt).numpy(), _np(want))


def test_lora_matmul_gathered_matches_xla_at_an_untileable_shape():
    B, H, R, N, S = 4, 2049, 5, 72, 3
    assert not lm.lora_matmul_supported(B, H, R, N)
    assert not ref_lm.lora_matmul_supported(B, H, R, N)
    x, ids, a, b = _mats(B, H, R, N, S, seed=1)
    want = ref_lm.lora_matmul_xla(jnp.asarray(x), jnp.asarray(ids),
                                  jnp.asarray(a), jnp.asarray(b))
    got = lm.lora_matmul_gathered(*_torch(x, ids, a, b))
    _close(got.numpy(), _np(want))


@pytest.mark.parametrize("shape", [
    (8, 4096, 8, 4096), (16, 4096, 64, 11008), (64, 8192, 16, 8192),
    (8, 128, 8, 128), (8, 4096, 512, 4096), (8, 4096, 8, 2051 * 128 + 1),
    (16, 14336, 16, 4096), (512, 4096, 16, 14336)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiling_rule_matches_reference(shape, dtype):
    """The copy of the reference's tiling rule (kept only for the CPU
    dispatch) answers as the reference does."""
    B, H, R, N = shape
    assert lm.pick_lora_blocks(B, H, R, N, getattr(torch, dtype)) == \
        ref_lm.pick_lora_blocks(B, H, R, N, getattr(jnp, dtype))


def test_null_slot_and_unmatched_id_give_exact_zero():
    B, H, R, N, S = 6, 600, 4, 40, 3
    x, _, a, b = _mats(B, H, R, N, S, seed=2)
    a[0] = 1.0       # slot 0's contents never reach a row
    b[0] = 1.0
    xt, at, bt = _torch(x, a, b)
    ids = torch.tensor([0, 1, 3, -1, 2, 0], dtype=torch.int32)
    for got in (lm.lora_matmul_ref(xt, ids, at, bt),
                lm.lora_expand_ref(lm.lora_shrink_ref(xt, ids, at), ids, bt)):
        null = torch.tensor([True, False, True, True, False, True])
        assert torch.all(got[null] == 0.0)
        assert torch.all(got[~null] != 0.0)
    part = lm.lora_shrink_ref(xt, ids, at)
    assert part.shape == (B, lm.lora_chunks(H), R) == (B, 2, R)


def test_row_delta_is_bitwise_independent_of_other_rows_and_slots():
    """Change every other row's id and every other slot's weights: row
    0's delta keeps every bit, in each plain version."""
    B, H, R, N, S = 8, 1100, 8, 96, 4
    x, _, a, b = _mats(B, H, R, N, S, seed=3)
    ids = np.full((B,), 2, np.int32)
    ids2 = np.array([2, 1, 3, 0, 1, 3, 0, 1], np.int32)
    a2, b2 = a.copy(), b.copy()
    rng = np.random.RandomState(9)
    for s in (1, 3):
        a2[s] = rng.randn(H, R) * 5.0
        b2[s] = rng.randn(R, N) * 5.0
    fns = {"ref": lm.lora_matmul_ref, "gathered": lm.lora_matmul_gathered,
           "pair": lambda x_, i_, a_, b_: lm.lora_expand_ref(
               lm.lora_shrink_ref(x_, i_, a_), i_, b_)}
    for name, fn in fns.items():
        base = fn(*_torch(x, ids, a, b))
        again = fn(*_torch(x, ids2, a2, b2))
        assert torch.equal(base[0], again[0]), name
        assert torch.equal(base[ids2 == 2], again[ids2 == 2]), name


@pytest.mark.parametrize("H", [256, 1100, 4096])
def test_shrink_expand_plain_versions_compose_to_the_delta(H):
    """The kernels' plain pair (H split in HCHUNK chunks, ragged tail
    included) computes the delta of lora_matmul_ref within 1e-5."""
    x, ids, a, b = _mats(16, H, 16, 200, 4, seed=4)
    xt, idt, at, bt = _torch(x, ids, a, b)
    pair = lm.lora_expand_ref(lm.lora_shrink_ref(xt, idt, at), idt, bt)
    _close(pair.numpy(), lm.lora_matmul_ref(xt, idt, at, bt).numpy())


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    x, ids, a, b = _torch(*_mats(4, 256, 8, 64, 3, seed=5))
    before = lm.lora_apply.launches
    assert torch.equal(lm.lora_matmul(x, ids, a, b),
                       lm.lora_matmul_ref(x, ids, a, b))
    buckets = lm.LoRABuckets([(a, b, 0)])
    y = torch.randn(4, 64)
    assert torch.equal(lm.lora_apply(x, None, ids, buckets),
                       lm.lora_matmul_ref(x, ids, a, b))
    assert torch.equal(lm.lora_apply(x, y, ids, buckets),
                       y + lm.lora_matmul_ref(x, ids, a, b))
    assert lm.lora_apply.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        lm.lora_matmul(x.to("meta"), ids, a, b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        lm.lora_apply(x.to("meta"), None, ids, buckets)


def test_lora_ctypes_signatures_match_the_cuda_source():
    """The C entry's ctypes argtypes mirror its prototype, and the bucket
    record packed for it mirrors the source's struct: a mismatch would
    pass garbage to the kernel, and only the card could show it."""
    src = (build.CSRC / lm.KERNEL_SOURCE).read_text()
    expect = {"void*": ctypes.c_void_p, "int": ctypes.c_int}
    assert set(re.findall(r'extern "C" int (\w+)\(', src)) == {"lora_apply"}
    proto = re.search(r'extern "C" int lora_apply\((.*?)\)\s*\{', src,
                      re.S).group(1)
    kinds = [expect[p.strip().replace("const ", "").rsplit(" ", 1)[0]
                    .replace(" ", "")] for p in proto.split(",")]
    assert kinds == lm.C_APPLY_ARGTYPES
    record = re.search(r"struct LoraBucketC \{.*?\n\};", src, re.S).group(0)
    assert re.findall(r"(int64_t|int32_t) ([\w, ]+);", record) == \
        [("int64_t", "a, b"), ("int32_t", "R, first, S, pad")]
    x, _, a, b = _torch(*_mats(2, 64, 8, 32, 3, seed=6))
    rec = lm.LoRABuckets([(a, b, 0), (a, b, 5)]).records()
    assert len(rec.raw) == 2 * 32
    assert np.frombuffer(rec.raw, np.int32).reshape(2, 8)[:, 4:].tolist() \
        == [[8, 0, 3, 0], [8, 5, 3, 0]]
    assert build.library_path(lm.KERNEL_SOURCE).name.startswith(
        "lora_matmul-")


# ------------------------------------------ one projection, every bucket
# two rank buckets of 4 slots (global slots 0-3 and 4-7), H 256, N 512
APPLY_RANKS, APPLY_SLOTS, APPLY_H, APPLY_N = (8, 16), 4, 256, 512


def _apply_case(seed):
    """Seeded per-bucket stacks (slot 0 zeros) as numpy, and the port's
    and the reference's views of them."""
    rng = np.random.RandomState(seed)
    stacks = {}
    for r in APPLY_RANKS:
        a = (rng.randn(APPLY_SLOTS, APPLY_H, r) * 0.05).astype(np.float32)
        b = (rng.randn(APPLY_SLOTS, r, APPLY_N) * 0.05).astype(np.float32)
        a[0] = b[0] = 0.0
        stacks[r] = (a, b)
    ours = lm.LoRABuckets([(*_torch(*stacks[r]), bi * APPLY_SLOTS)
                           for bi, r in enumerate(APPLY_RANKS)])
    layout = types.SimpleNamespace(rank_buckets=APPLY_RANKS,
                                   slots=APPLY_SLOTS,
                                   dims={"proj": (APPLY_H, APPLY_N)})
    theirs = {r: {"proj": tuple(jnp.asarray(m) for m in stacks[r])}
              for r in APPLY_RANKS}
    return rng, ours, layout, theirs


def _ulp_close(got, want, dtype, delta_tol):
    """Elementwise within one unit in the last place of y's dtype, beyond
    the delta's own tolerance (which the sum carries into fp32 outputs;
    in bf16 it is ~1e-5 of an ulp)."""
    got, want = (np.asarray(v, np.float64) for v in (got, want))
    mag = np.maximum(np.abs(got), np.abs(want))
    mant = 7 if dtype == "bfloat16" else 23
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - mant)
    assert np.all(np.abs(got - want) <= ulp + delta_tol), \
        np.abs(got - want).max()


def _jax_out(a):
    return np.asarray(getattr(a, "_data", a)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t", [(12, 1), (2, 5)], ids=["decode", "prefill"])
def test_lora_apply_matches_reference_hook(dtype, b, t):
    """Decode rows (the reference's interpret-mode kernel) and prefill
    chunks (its gathered composition), rows in both buckets, null rows
    (global slots 0 and 4) and ids naming no slot (8, -1): the plain
    version's fp32 delta within 1e-5 of the reference's max |delta|, y +
    delta within one ulp of y's dtype beyond that, null rows exactly y +
    0.0."""
    rng, ours, layout, theirs = _apply_case(seed=11 + t)
    slots = np.array([1, 5, 0, 3, 7, 4, 2, 8, 6, -1, 5, 1][:b], np.int32)
    x = rng.randn(b, t, APPLY_H).astype(np.float32)
    y = rng.randn(b, t, APPLY_N).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    yt = torch.from_numpy(y).to(getattr(torch, dtype))
    x, y = xt.float().numpy(), yt.float().numpy()    # the same bits
    xj = jnp.asarray(x).astype(dtype)
    yj = jnp.asarray(y).astype(dtype)
    ctx = ref_rt.LoRAContext(layout, theirs, jnp.asarray(slots))
    with ref_rt.lora_scope(ctx):
        want_out = _jax_out(ref_rt.apply_lora("proj", xj, yj))
    want_delta = np.asarray(ctx.delta("proj", xj))
    st = torch.from_numpy(slots)
    x2, y2 = xt.reshape(b * t, -1), yt.reshape(b * t, -1)
    delta = lm.lora_apply(x2, None, st, ours)
    out = lm.lora_apply(x2, y2, st, ours)
    assert delta.dtype == torch.float32 and out.dtype == yt.dtype
    _close(delta.numpy().reshape(b, t, -1), want_delta)
    _ulp_close(out.float().numpy().reshape(b, t, -1), want_out, dtype,
               1e-5 * np.abs(want_delta).max())
    null = np.isin(slots, [0, 4, 8, -1])
    assert torch.equal(out.reshape(b, t, -1)[torch.from_numpy(null)],
                       yt[torch.from_numpy(null)] + 0.0)
    assert torch.all(delta.reshape(b, t, -1)[torch.from_numpy(null)] == 0.0)
    # the plain version is the old composition: bucket by bucket
    assert torch.equal(out, y2 + delta.to(y2.dtype))


def _brute_groups(row_slots, tokens, buckets):
    """{(bucket, slot) or None: rows} straight from the definition."""
    groups = {}
    for m in range(len(row_slots) * tokens):
        g = int(row_slots[m // tokens])
        key = None
        for b, (first, S) in enumerate(buckets):
            if first <= g < first + S:
                key = (b, g - first) if g > first else None
        groups.setdefault(key, []).append(m)
    return groups


@pytest.mark.parametrize("seed", range(6))
def test_grouping_rule_matches_brute_force(seed):
    """`lora_groups` (the kernel's rule) partitions the rows by (bucket,
    slot) as the definition does: keys in (bucket, slot) order, the null
    key last, a key's rows in order, cut into units of T rows; no plan
    for these shapes bounds fewer units than the ids make."""
    rng = np.random.RandomState(seed)
    buckets = [(0, int(rng.randint(1, 6)))]
    for _ in range(int(rng.randint(0, 3))):
        first, S = buckets[-1]
        buckets.append((first + S + int(rng.randint(0, 3)),
                        int(rng.randint(1, 6))))
    top = buckets[-1][0] + buckets[-1][1]
    B = int(rng.randint(1, 40))
    tokens = int(rng.choice([1, 1, 3, 70]))
    T = int(rng.choice([16, 64]))
    row_slots = rng.randint(-2, top + 2, B)
    units = lm.lora_groups(row_slots, tokens, buckets, T)
    brute = _brute_groups(row_slots, tokens, buckets)
    keys = sorted((k for k in brute if k is not None)) + \
        ([None] if None in brute else [])
    want = [(k, rows[j:j + T]) for k in keys
            for rows in [brute[k]] for j in range(0, len(rows), T)]
    got = [((b, s) if b is not None else None, rows) for b, s, rows in units]
    assert got == want
    ranks = [8] * len(buckets)
    _, _, T_plan, _, bound = lm.lora_apply_plan(
        B * tokens, B, 256, 512, tuple(ranks), tuple(S for _, S in buckets),
        132)
    assert T_plan == 64
    if T == 64:
        assert len(units) <= bound


def test_grid_plan_is_a_function_of_the_shapes():
    """The plan takes shapes only (the host never reads the ids) and
    bounds the units of the worst ids; serving's shapes get clusters of
    8 CTAs splitting H 4096 and 14336."""
    import inspect
    params = list(inspect.signature(lm.lora_apply_plan).parameters)
    assert params == ["M", "B", "H", "N", "ranks", "slots", "sms"]
    plan = lm.lora_apply_plan(16, 16, 4096, 14336, (8, 16), (4, 4), 132)
    assert plan == lm.lora_apply_plan(16, 16, 4096, 14336, (8, 16), (4, 4),
                                      132)
    C, K, T, HC, units = plan
    assert (C, T, HC, units) == (8, 64, 64, 7)
    assert K * C * units <= 2 * 132
    assert lm.lora_apply_plan(512, 1, 14336, 4096, (8, 16), (4, 4),
                              132)[:5:4] == (8, 8)
    assert lm.lora_apply_plan(4, 4, 256, 64, (256,), (3,), 132)[:4] == \
        (1, 1, 16, 16)
    # the worst ids: every entry its own slot, each key's last unit short
    for M, B, S in ((16, 16, 4), (700, 700, 9), (130, 2, 3), (64, 64, 70)):
        slots = np.arange(B) % (2 * S)
        for T in (16, 64):
            ranks = (8,) if T == 64 else (128,)
            got = len(lm.lora_groups(slots, M // B, [(0, S), (S, S)], T))
            assert got <= lm.lora_apply_plan(M, B, 256, 64, ranks * 2,
                                             (S, S), 132)[4]


# --------------------------------------------------------------- adapters
def test_adapters_cross_bitwise():
    """LoRAAdapter.random builds the reference's adapter from the same
    seed; from_jax_adapter carries a reference adapter across."""
    ref = ref_adapter.LoRAAdapter.random("x", 4, DIMS, seed=3, alpha=8.0)
    ours = LoRAAdapter.random("x", 4, DIMS, seed=3, alpha=8.0)
    conv = from_jax_adapter(ref)
    for ad in (ours, conv):
        assert (ad.name, ad.rank, ad.alpha, ad.scaling) == \
            (ref.name, ref.rank, ref.alpha, ref.scaling)
        assert sorted(ad.weights) == sorted(ref.weights)
        for m, (a, b) in ref.weights.items():
            assert np.array_equal(ad.weights[m][0], a)
            assert np.array_equal(ad.weights[m][1], b)
    with pytest.raises(ValueError):
        LoRAAdapter("bad", 4, {"q_proj": (np.zeros((8, 3)),
                                          np.zeros((4, 8)))})


def _bits_equal(ours, ref):
    ref = np.asarray(ref)
    ours = ours.cpu().numpy()
    return ours.dtype == ref.dtype and ours.shape == ref.shape and \
        np.array_equal(ours.view(np.uint8), ref.view(np.uint8))


def _state(reg):
    return ({n: (e.bucket, e.local, e.quant, e.refs, e.last_use, e.gen,
                 e.scaling, list(e.seq.pages))
             for n, e in sorted(reg.entries.items())},
            {r: list(v) for r, v in reg._free_slots.items()},
            list(reg.allocator._free), list(reg.quant_allocator._free),
            {k: v for k, v in reg.counters.items() if v},
            reg.signature())


def _adapters(name, rank, seed):
    ref = ref_adapter.LoRAAdapter.random(name, rank, DIMS, seed=seed)
    return from_jax_adapter(ref), ref


def _apply(regs, op, *args):
    """Run one registry operation on (port, reference); returns the
    exception type names (None when it returned)."""
    out = []
    for reg, side in zip(regs, ("port", "ref")):
        a = [x[0 if side == "port" else 1] if isinstance(x, tuple) else x
             for x in args]
        try:
            getattr(reg, op)(*a)
            out.append(None)
        except Exception as exc:   # noqa: BLE001 — compared by type name
            out.append(type(exc).__name__)
    return out


def test_registry_matches_reference_under_load_evict_and_faults():
    """One sequence of loads (fp32 and int8), acquire/release, unload,
    replace, LRU slot eviction, page-pressure eviction and both fault
    points: slots, pages, refs, generations, counters, signature and
    every flat_args() array stay equal to the reference's, bitwise."""
    per = AdapterRegistry(DIMS, rank_buckets=(4,), slots=2,
                          device="cpu").layout.pages_per_adapter[4]
    kw = dict(rank_buckets=(4, 8), slots=3, num_pages=2 * per + 1)
    port = AdapterRegistry(DIMS, device="cpu", **kw)
    ref = ref_store.AdapterRegistry(DIMS, **kw)
    regs = (port, ref)
    a1, a2, a3 = (_adapters("a1", 4, 1), _adapters("a2", 8, 2),
                  _adapters("a3", 3, 3))
    a4, a5, a1b = (_adapters("a4", 4, 4), _adapters("a5", 6, 5),
                   _adapters("a1", 4, 11))
    steps = [("load", a1), ("load", a2, "int8"), ("load", a3),
             ("acquire", "a1"), ("acquire", "a2"),
             ("load", a4),                  # bucket 4 full: evicts idle a3
             ("unload", "a2"),              # busy: typed refusal
             ("release", "a2"), ("release", "a1"),
             ("load", a1b),                 # replace in place: new gen
             ("load", a5),                  # fp32 pages full: LRU evicts
             ("unload", "a2"), ("unload", "nope"),
             ("load", a2, "int8"), ("acquire", "a2")]
    for step in steps:
        got = _apply(regs, *step)
        assert got[0] == got[1], (step, got)
        assert _state(port) == _state(ref), step
    for reg in regs:                # nothing idle: eviction must refuse
        for name in list(reg.entries):
            reg.acquire(name)
    for fault, payload in (("serving.lora.load_fail", True),
                           ("serving.lora.evict_race", True)):
        with faults.injected(fault, payload=payload), \
                ref_faults.injected(fault, payload=payload):
            got = _apply(regs, "load", _adapters("a6", 4, 6))
        assert got[0] == got[1] == "AdapterLoadError", (fault, got)
        assert _state(port) == _state(ref), fault
    assert port.counters["adapter_load_failures"] >= 2
    assert port.counters["lora_evict_refusals"] == 1
    assert port.counters["adapters_evicted"] >= 2
    for ours, want in zip(port.flat_args(), ref.flat_args()):
        assert _bits_equal(ours, want)
    port.check_invariants()


def test_build_context_stacks_equal_reference_bitwise():
    """fp32 and int8 adapters in two rank buckets: every gathered,
    dequantized, scaling-folded stack is the reference's bits, and the
    delta of each module is within 1e-5 of the reference's (decode rows
    through its kernel, a prefill chunk through its gathered route)."""
    kw = dict(rank_buckets=(4, 8), slots=3)
    port = AdapterRegistry(DIMS, device="cpu", **kw)
    ref = ref_store.AdapterRegistry(DIMS, **kw)
    for name, rank, seed, quant in (("f", 4, 1, None), ("q", 8, 2, "int8"),
                                    ("g", 6, 3, None)):
        ours, theirs = _adapters(name, rank, seed)
        assert port.load(ours, quant=quant) == ref.load(theirs, quant=quant)
    slots = np.array([port.slot_of("f"), 0, port.slot_of("q"),
                      port.slot_of("g")], np.int32)
    ctx = build_context(port.layout, port.flat_args(), torch.from_numpy(slots))
    # the reference builds its context inside its jitted launch programs
    stacks = jax.jit(lambda fa, rs: ref_rt.build_context(
        ref.layout, fa, rs).stacks)(ref.flat_args(), jnp.asarray(slots))
    rctx = ref_rt.LoRAContext(ref.layout, stacks, jnp.asarray(slots))
    for r in port.layout.rank_buckets:
        for m in DIMS:
            for ours, want in zip(ctx.stacks[r][m], rctx.stacks[r][m]):
                assert _bits_equal(ours, want), (r, m)
    rng = np.random.RandomState(8)
    for t, m in ((1, "down_proj"), (5, "q_proj")):
        x = rng.randn(4, t, DIMS[m][0]).astype(np.float32)
        got = ctx.delta(m, torch.from_numpy(x))
        want = rctx.delta(m, jnp.asarray(x))
        _close(got.numpy(), _np(want))
        assert torch.all(got[1] == 0.0)               # the base row


def test_hook_returns_the_projection_output_itself_without_a_scope():
    x = torch.randn(2, 1, 128)
    y = torch.randn(2, 1, 128)
    assert current_lora() is None
    assert apply_lora("q_proj", x, y) is y
    reg = AdapterRegistry(DIMS, device="cpu", slots=2)
    reg.load(LoRAAdapter.random("a", 4, {"q_proj": DIMS["q_proj"]}, seed=1))
    ctx = build_context(reg.layout, reg.flat_args(),
                        torch.tensor([1, 0], dtype=torch.int32))
    with lora_scope(ctx):
        assert current_lora() is ctx
        out = apply_lora("q_proj", x, y)
        assert apply_lora("o_proj", x, y) is not y   # targeted, zero delta
    assert current_lora() is None
    assert torch.equal(out[1], y[1]) and not torch.equal(out[0], y[0])
    with pytest.raises(AdapterBusy):
        reg.acquire("a")
        reg.unload("a")
    with pytest.raises(AdapterLoadError):
        reg.load(LoRAAdapter.random("big", 16, DIMS, seed=2))
