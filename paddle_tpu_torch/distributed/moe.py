"""Mixture of experts (port of `paddle_tpu/distributed/moe.py`).

Ported: `number_count` :38, `limit_by_capacity` :45, the sort-based
routing `_sort_dispatch` :53 / `_sort_combine` :95 behind
`moe_dispatch_combine` :102 and `moe_combine` :114, `TopKGate` :143,
`SwitchGate` :159 and `MoELayer` :167.

Routing keeps the reference's static shapes and its rules, bit for bit:
each token's top-k experts (on equal gates the lower expert id first, as
`jax.lax.top_k` orders them: a stable descending sort), their gates
renormalised to sum to 1; assignments grouped by expert in a stable sort
(so earlier tokens win a full expert's capacity), slots `e * C + pos`,
assignments past `capacity` sent to a sentinel slot E * C that is
dropped. Nothing in dispatch or combine reads a value back to the host:
expert counts are a `scatter_add_` into zeros (never `bincount`), and
`capacity` is a Python int from the token count.

The combine is deterministic. The reference scatter-adds every slot's
weighted output into its token; `index_add_` on the card adds in atomic
order. Here dispatch also returns each token's k slots in ascending
order (ascending expert id, the order of the reference's scatter), and
the combine gathers them and adds them in that order. A dropped
assignment adds nothing; an empty slot feeds no token. So
`moe_dispatch_combine`'s combine info is (slot_tok, slot_w, tok_slots):
the reference's pair and the token-major (T, k) slot table.

`MoELayer` runs its E identical experts as one batched computation, the
counterpart of the reference's `jax.vmap(functional_call(...))` over
stacked parameters: `StackedExperts` holds each parameter of the expert
once with a leading axis of E (stacked at construction, or built slice
by slice on the target device by `StackedExperts.build`), and its
forward is `torch.vmap` of `torch.func.functional_call` over a template
on the `meta` device, so every projection is one batched GEMM over the
dispatched (E, C, d) slab. Its state dict names are the expert's own
under `experts.` (`experts.gate_proj.weight` of shape (E, in, out));
`models/convert.py` stacks the reference's per-expert names into them.

Not ported: expert parallelism. `global_scatter` / `global_gather`
(:125, :136) and the `MoELayer`'s EP sharding of the expert axis need an
`all_to_all`, which gloo cannot run on CUDA tensors; a `MoELayer` given
a group or a model-parallel mesh of more than one rank raises.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn.layer.common import Linear

__all__ = ["TopKGate", "SwitchGate", "MoELayer", "StackedExperts",
           "moe_dispatch_combine", "moe_combine", "number_count",
           "limit_by_capacity"]


def number_count(gate_idx, upper_range: int):
    """Tokens per expert (int64, length `upper_range`), as the
    reference's `jnp.bincount(..., length=upper_range)`: a negative id
    counts for expert 0, an id past the range is dropped. A scatter into
    zeros: no host sync."""
    idx = gate_idx.reshape(-1).long().clamp_min(0)
    inside = idx < upper_range
    counts = torch.zeros(upper_range, dtype=torch.int64, device=idx.device)
    return counts.scatter_add_(0, idx.clamp_max(upper_range - 1),
                               inside.long())


def limit_by_capacity(expert_count, capacity, n_worker: int = 1):
    """Per-expert counts clamped to `capacity` (an int or a tensor), in
    the counts' dtype."""
    cap = torch.as_tensor(capacity, device=expert_count.device)
    return torch.minimum(expert_count, cap).to(expert_count.dtype)


def _top_k(gates, k: int):
    """(values, ids) of each row's k largest gates, ties to the lower
    expert id (`jax.lax.top_k`'s order): a stable descending sort."""
    vals, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


class Routing(NamedTuple):
    """The routing of T tokens over E experts of capacity C."""
    slot_tok: torch.Tensor    # (E*C,) int64 token of each slot (0 if empty)
    slot_w: torch.Tensor      # (E*C,) combine weight (0 for an empty slot)
    tok_slots: torch.Tensor   # (T, k) each token's slots, ascending; E*C
    #                           for a dropped assignment
    counts: torch.Tensor      # (E,) int64 assignments before the cut
    valid: torch.Tensor       # (E*C,) bool: the slot holds an assignment
    slot: torch.Tensor        # (T*k,) the slot of each assignment in
    #                           expert order (E*C if dropped)
    tokens: torch.Tensor      # (T*k,) its token


def _route(gates, topk: int, capacity: int) -> Routing:
    """The routing of gates (T, E) (see `Routing`)."""
    T, E = gates.shape
    n = T * topk
    ec = E * capacity
    vals, ids = _top_k(gates, topk)
    # the reference's jnp.sum over k: adds in order, in the gates' dtype
    total = vals[:, 0]
    for j in range(1, topk):
        total = total + vals[:, j]
    vals = vals / total.clamp_min(1e-9)[:, None]
    flat_e = ids.reshape(-1)
    flat_w = vals.reshape(-1)
    dev = gates.device
    flat_t = torch.arange(n, device=dev) // topk
    order = torch.sort(flat_e, stable=True).indices
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = number_count(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts[se]
    slot = torch.where(pos < capacity, se * capacity + pos,
                       torch.full_like(pos, ec))
    # the sentinel E*C takes every dropped assignment, in no set order:
    # its entry is cut off
    slot_tok = torch.zeros(ec + 1, dtype=torch.int64, device=dev) \
        .scatter(0, slot, st)[:-1]
    slot_w = torch.zeros(ec + 1, dtype=gates.dtype, device=dev) \
        .scatter(0, slot, sw)[:-1]
    valid = torch.zeros(ec + 1, dtype=torch.bool, device=dev) \
        .scatter(0, slot, torch.ones_like(slot, dtype=torch.bool))[:-1]
    tok_slots = torch.empty_like(slot).scatter(0, order, slot)
    tok_slots = torch.sort(tok_slots.view(T, topk), dim=1).values
    return Routing(slot_tok, slot_w * valid, tok_slots, counts, valid, slot,
                   st)


def _sort_dispatch(x, gates, topk: int, capacity: int):
    """x (T, d), gates (T, E) softmax probabilities -> (expert_in
    (E, C, d), slot_tok, slot_w, aux, tok_slots): the reference's
    moe_gate_dispatch, with the GShard load-balancing loss
    aux = E * sum_e mean(gates_e) * min(count_e, C) / T."""
    T, d = x.shape
    E = gates.shape[1]
    r = _route(gates, topk, capacity)
    # each assignment's token row written into its slot (the sentinel row
    # E*C, cut off, takes the dropped ones): the backward gathers the
    # assignments' rows and adds k of them a token, where gathering
    # x[slot_tok] would add every empty slot's zero row into token 0, one
    # row at a time
    buf = torch.zeros(E * capacity + 1, d, dtype=x.dtype, device=x.device)
    expert_in = buf.index_put((r.slot,), x[r.tokens])[:-1]
    me = gates.mean(dim=0)
    frac = r.counts.clamp_max(capacity).to(gates.dtype) / T
    aux = E * (me * frac).sum()
    return (expert_in.reshape(E, capacity, d), r.slot_tok, r.slot_w, aux,
            r.tok_slots)


def _sort_combine(expert_out, slot_w, tok_slots):
    """Each token's weighted expert outputs, gathered from its slots and
    added in ascending slot order (the reference's scatter-add order)."""
    E, C, d = expert_out.shape
    ec = E * C
    flat = expert_out.reshape(ec, d)
    live = tok_slots < ec
    # a dropped assignment reads (and, backward, adds a zero into) a slot
    # of its own position, so no one slot collects them all
    spread = torch.arange(live.numel(), device=live.device).view_as(live)
    idx = torch.where(live, tok_slots, spread % ec)
    zero = torch.zeros((), dtype=expert_out.dtype, device=expert_out.device)
    terms = torch.where(live[..., None], flat[idx] * slot_w[idx][..., None],
                        zero)
    out = terms[:, 0]
    for j in range(1, terms.shape[1]):
        out = out + terms[:, j]
    return out


def moe_dispatch_combine(x, gates, topk: int, capacity: int):
    """x (tokens, d), gates (tokens, experts) -> (expert_inputs
    (experts, capacity, d), combine_info, aux). Feed combine_info
    (slot_tok, slot_w, tok_slots) to `moe_combine` after the experts."""
    expert_in, slot_tok, slot_w, aux, tok_slots = _sort_dispatch(
        x, gates, topk, capacity)
    return expert_in, (slot_tok, slot_w, tok_slots), aux


def moe_combine(expert_out, combine_info, num_tokens: int):
    """expert_out (E, C, d) + combine_info of `moe_dispatch_combine` ->
    (num_tokens, d)."""
    _, slot_w, tok_slots = combine_info
    if tok_slots.shape[0] != num_tokens:
        raise ValueError(f"combine info routes {tok_slots.shape[0]} tokens, "
                         f"not {num_tokens}")
    return _sort_combine(expert_out, slot_w, tok_slots)


class TopKGate(nn.Module):
    """GShard-style top-k gate: softmax of `wg(x)` (no bias), taken in
    the logits' dtype. Built on `device` (the card unless told
    otherwise)."""

    def __init__(self, d_model: int, num_experts: int, topk: int = 2,
                 capacity_factor: float = 1.25, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.wg = Linear(d_model, num_experts, bias=False,
                         device=resolve_device(device), dtype=dtype,
                         generator=generator)
        self.topk = topk
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor

    def forward(self, x):
        return torch.softmax(self.wg(x), dim=-1)


class SwitchGate(TopKGate):
    """The top-1 gate."""

    def __init__(self, d_model: int, num_experts: int,
                 capacity_factor: float = 1.25, **kw):
        super().__init__(d_model, num_experts, topk=1,
                         capacity_factor=capacity_factor, **kw)


def _attach(root: nn.Module, name: str, param: nn.Parameter):
    """Register `param` at the dotted `name` under `root`, making empty
    container modules for the path."""
    *path, leaf = name.split(".")
    mod = root
    for part in path:
        if part not in mod._modules:
            mod.add_module(part, nn.Module())
        mod = mod._modules[part]
    mod.register_parameter(leaf, param)


class StackedExperts(nn.Module):
    """E identical experts (modules with parameters and no buffers) as
    one module: each of the expert's parameters once, with a leading axis
    of E, under the expert's own names. forward(x (E, C, d)) runs expert
    e on x[e] for every e at once: `torch.vmap` of `functional_call` over
    a template of the expert on the `meta` device (held outside the
    module tree, so it is in no state dict and moves with no `.to`)."""

    def __init__(self, template: nn.Module, params: Dict[str, torch.Tensor]):
        super().__init__()
        object.__setattr__(self, "template", template.to("meta"))
        self.num_experts = int(next(iter(params.values())).shape[0])
        for name, t in params.items():
            _attach(self, name, nn.Parameter(t))

    @classmethod
    def from_modules(cls, experts: Sequence[nn.Module]) -> "StackedExperts":
        """Stack a list of identical expert modules (copies: the list
        can be freed)."""
        experts = list(experts)
        params, _ = torch.func.stack_module_state(experts)
        return cls(copy.deepcopy(experts[0]), params)

    @classmethod
    def build(cls, factory: Callable[..., nn.Module], num_experts: int, *,
              device=None, dtype=None, generator=None) -> "StackedExperts":
        """E experts made by `factory(device=, dtype=, generator=)`, one
        at a time, each copied into its slice of the stacked parameters
        on `device` and freed: every expert initialised as its own module
        initialises itself (a Linear: Xavier at its own fan), from one
        generator in expert order, with one expert's memory beside the
        stack."""
        template = factory(device="meta", dtype=dtype, generator=None)
        stacked = {name: torch.empty((num_experts,) + tuple(t.shape),
                                     dtype=t.dtype, device=device)
                   for name, t in template.named_parameters()}
        with torch.no_grad():
            for e in range(num_experts):
                one = factory(device=device, dtype=dtype, generator=generator)
                for name, t in one.named_parameters():
                    stacked[name][e].copy_(t)
                del one
        return cls(template, stacked)

    def __len__(self):
        return self.num_experts

    def forward(self, x):
        def one(p, xin):
            return torch.func.functional_call(self.template, p, (xin,))
        return torch.vmap(one)(dict(self.named_parameters()), x)


class MoELayer(nn.Module):
    """Mixture-of-experts layer: the gate, the sort-based capacity
    routing, the E experts as one batched computation, the deterministic
    combine. `experts`: a list of identical expert modules (stacked
    here) or a `StackedExperts`. `gate` defaults to a `TopKGate` on the
    experts' device. Each forward sets `self.aux_loss` (the GShard
    load-balancing loss of that call). `recompute_interval` is accepted
    and, as in the reference, unused.

    Expert parallelism is not ported: a `group` or a `mesh` of more than
    one rank raises NotImplementedError."""

    def __init__(self, d_model: int, experts=None, gate=None,
                 num_experts: Optional[int] = None, topk: int = 2,
                 capacity_factor: float = 1.25, group=None,
                 recompute_interval: int = 0, *, mesh=None):
        super().__init__()
        if group is not None or (mesh is not None and mesh.tp > 1):
            raise NotImplementedError(
                "expert parallelism (MoELayer over a group or an EP mesh: "
                "global_scatter / global_gather) is not ported to "
                "paddle_tpu_torch")
        if experts is None:
            raise ValueError("experts list required")
        self.experts = (experts if isinstance(experts, StackedExperts)
                        else StackedExperts.from_modules(experts))
        self.num_experts = num_experts or len(self.experts)
        if gate is None:
            first = next(self.experts.parameters())
            gate = TopKGate(d_model, self.num_experts, topk, capacity_factor,
                            device=first.device, dtype=first.dtype)
        self.gate = gate
        self.topk = getattr(self.gate, "topk", topk)
        self.capacity_factor = capacity_factor
        self.d_model = d_model
        self.aux_loss = None

    def forward(self, x):
        shape = x.shape
        xf = x.reshape(-1, self.d_model)
        tokens = xf.shape[0]
        gates = self.gate(xf)
        capacity = max(1, int(self.capacity_factor * tokens * self.topk
                              / self.num_experts))
        expert_in, info, aux = moe_dispatch_combine(xf, gates, self.topk,
                                                    capacity)
        out = moe_combine(self.experts(expert_in), info, tokens)
        self.aux_loss = aux
        return out.reshape(shape)
