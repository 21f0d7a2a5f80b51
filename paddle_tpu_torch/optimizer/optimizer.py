"""Optimizer base and AdamW (port of `paddle_tpu/optimizer/optimizer.py`,
as far as AdamW needs it).

Parameters are `torch.nn.Parameter`s; `step()` reads their `.grad` and
writes the updated values into them in place. `multi_precision=True`
keeps an fp32 master weight for every non-fp32 parameter;
`moment_dtype="bfloat16"` stores both moments in bf16 while the update
math runs in fp32 (upcast on read, round on store).

`AdamW(..., fused=True)` packs every eligible parameter into one padded
(rows, 128) bucket per (dtype, lr multiplier, decay on) group and runs
the whole update as one pass of `kernels/fused_optimizer.py`'s kernel
(one read and one write per state byte). Moments and master weights
then LIVE in bucket form and are updated in place; `state_dict()`
de-bucketizes them to the canonical per-parameter keys `moment1_<i>`,
`moment2_<i>`, `master_<i>` and `@step`, the reference's, so a
checkpoint crosses between fused and per-parameter optimizers and from
the reference (`models/convert.py::from_jax_optimizer_state`);
`set_state_dict` re-buckets lazily at the next step. Eligible: fp32
parameters, or bf16 parameters under multi_precision. The per-parameter
`_apply_one` and the fused update round identically for fp32 state.

Not ported (they raise): grad_clip, LR schedulers, amsgrad, lr_ratio,
ZeRO-1 over a 'sharding' mesh, and the rest of the optimizer zoo.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels.fused_optimizer import (LANES, adamw_scalars,
                                       build_bucket_layout,
                                       fused_adamw_bucket, pack_bucket,
                                       unpack_bucket)

__all__ = ["Optimizer", "AdamW"]

# accumulator slots that hold BUCKETED fused state rather than
# per-parameter tensors; state_dict() de-bucketizes them
_FUSED_SLOTS = ("fused_m", "fused_v", "fused_master")


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported to paddle_tpu_torch "
                               "(see ROADMAP.md)")


def _dtype(d):
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, grad_clip=None,
                 multi_precision=False, moment_dtype=None, fused=None):
        if parameters is None:
            raise ValueError("paddle_tpu_torch optimizers require an "
                             "explicit parameter list (model.parameters())")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            params = [p for group in params for p in group["params"]]
        self._parameter_list = params
        if grad_clip is not None:
            raise _not_ported("grad_clip")
        if not isinstance(learning_rate, (int, float)):
            raise _not_ported("an LRScheduler learning rate")
        self._learning_rate = float(learning_rate)
        self._multi_precision = bool(multi_precision)
        # accumulators: slot name -> param index -> tensor
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0
        self._moment_dtype = (_dtype(moment_dtype)
                              if moment_dtype is not None else None)
        self._fused = bool(fused)
        # fused bucket bookkeeping: group key -> {uid, layout, sig}; only
        # the tensors live in _accumulators
        self._fused_buckets: Dict = {}

    # ------------------------------------------------------------------ lr
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # ------------------------------------------------------- accumulators
    def _acc(self, name: str, idx: int, like: torch.Tensor,
             fill=0.0) -> torch.Tensor:
        """Accumulator read: stored in moment_dtype when set (else fp32
        under multi_precision, else the parameter's dtype), returned in
        fp32 when narrowed so the update math runs full precision."""
        slot = self._accumulators.setdefault(name, {})
        if idx not in slot:
            dtype = self._moment_dtype if self._moment_dtype is not None \
                else (torch.float32 if self._multi_precision else like.dtype)
            slot[idx] = torch.full(like.shape, fill, dtype=dtype,
                                   device=like.device)
        a = slot[idx]
        if self._moment_dtype is not None and a.dtype == self._moment_dtype:
            return a.float()
        return a

    def _set_acc(self, name: str, idx: int, value):
        if self._moment_dtype is not None:
            value = value.to(self._moment_dtype)
        self._accumulators[name][idx] = value

    def _master(self, idx: int, p) -> torch.Tensor:
        if not self._multi_precision or p.dtype == torch.float32:
            return p.detach()
        if idx not in self._master_weights:
            self._master_weights[idx] = p.detach().float()
        return self._master_weights[idx]

    def _writeback(self, idx: int, p, new_master):
        if self._multi_precision and p.dtype != torch.float32:
            self._master_weights[idx] = new_master
        p.detach().copy_(new_master)

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        lr = self.get_lr()
        self._step_count += 1
        if self._fused and params_grads:
            # returns the (p, g) pairs the fused path did not handle
            params_grads = self._fused_step(params_grads, lr)
        todo = {id(p): g for p, g in params_grads}
        for idx, p in enumerate(self._parameter_list):
            g = todo.get(id(p))
            if g is not None:
                self._apply_one(idx, p, g,
                                lr * getattr(p, "_lr_scale", 1.0))

    def _fused_step(self, params_grads, lr):
        """Fused multi-tensor hook: handle what you can, return the rest
        for the per-parameter loop. Base: nothing is handled."""
        return params_grads

    def _apply_one(self, idx: int, p, g, lr: float):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Drop every gradient, which frees its memory: the reference's
        Tensor.clear_grad sets the buffer to None whatever
        `set_to_zero` says."""
        for p in self._parameter_list:
            p.grad = None

    # --------------------------------------------- fused bucket plumbing
    def _fused_state_entries(self):
        """{canonical key: view} of every bucketed slot, sliced from the
        live buckets."""
        out = {}
        for rec in self._fused_buckets.values():
            uid, layout = rec["uid"], rec["layout"]
            for slot, canon in (("fused_m", "moment1"),
                                ("fused_v", "moment2"),
                                ("fused_master", "master")):
                bucket = self._accumulators.get(slot, {}).get(uid)
                if bucket is None:
                    continue
                for arr, (idx, _, _, _) in zip(
                        unpack_bucket(bucket, layout), layout.entries):
                    out[f"{canon}_{idx}"] = arr
        return out

    def _drop_fused_buckets(self, debucketize=False):
        """Forget bucketed storage, optionally writing it back to the
        canonical per-parameter slots first (layout-change path)."""
        if debucketize:
            for key, arr in self._fused_state_entries().items():
                name, idx = key.rsplit("_", 1)
                if name == "master":
                    self._master_weights[int(idx)] = arr
                else:
                    self._accumulators.setdefault(name, {})[int(idx)] = arr
        for slot in _FUSED_SLOTS:
            self._accumulators.pop(slot, None)
        self._fused_buckets.clear()

    # ------------------------------------------------------------ state IO
    def state_dict(self):
        """Canonical per-parameter state: `<slot>_<i>` tensors (copies),
        `master_<i>`, and `@step`."""
        out = {}
        for name, slot in self._accumulators.items():
            if name in _FUSED_SLOTS:
                continue    # exported in canonical form below
            for idx, arr in slot.items():
                out[f"{name}_{idx}"] = arr.clone()
        for idx, arr in self._master_weights.items():
            out[f"master_{idx}"] = arr.clone()
        for key, arr in self._fused_state_entries().items():
            out[key] = arr.clone()
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state):
        """Load canonical entries (tensors or numpy arrays), each onto its
        parameter's device. Live buckets are de-bucketized first, so a
        partial state dict overwrites only the keys it carries; the fused
        path re-buckets at the next step."""
        self._drop_fused_buckets(debucketize=True)
        for key, v in state.items():
            if key == "@step":
                self._step_count = int(v)
                continue
            name, idx = key.rsplit("_", 1)
            idx = int(idx)
            arr = torch.as_tensor(v).to(self._parameter_list[idx].device)
            if name == "master":
                self._master_weights[idx] = arr
            else:
                self._accumulators.setdefault(name, {})[idx] = arr
        return self


class AdamW(Optimizer):
    """Adam with decoupled weight decay (reference:
    python/paddle/optimizer/adamw.py). `lazy_mode` and `name` are
    accepted and, as in the reference, change nothing for dense
    gradients."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, moment_dtype=None, fused=None):
        super().__init__(learning_rate, parameters, grad_clip,
                         multi_precision, moment_dtype=moment_dtype,
                         fused=fused)
        if amsgrad:
            raise _not_ported("amsgrad")
        if lr_ratio is not None:
            raise _not_ported("lr_ratio")
        if not isinstance(weight_decay, (int, float, type(None))):
            raise _not_ported(f"weight_decay={weight_decay!r} (a float)")
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_fn = apply_decay_param_fun

    def _decay_on(self, idx, p) -> bool:
        return self._wd != 0.0 and (
            self._apply_decay_fn is None
            or self._apply_decay_fn(getattr(p, "name", None)
                                    or f"param_{idx}"))

    def _apply_one(self, idx, p, g, lr):
        m_w = self._master(idx, p)
        if self._decay_on(idx, p):
            m_w = m_w * (1.0 - lr * self._wd)
        g = g.to(m_w.dtype)
        m = self._acc("moment1", idx, m_w)
        v = self._acc("moment2", idx, m_w)
        t = self._step_count
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", idx, m)
        self._set_acc("moment2", idx, v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        self._writeback(idx, p,
                        m_w - lr * mhat / (torch.sqrt(vhat) + self._eps))

    # ------------------------------------------------------- fused update
    def _fused_eligible(self, p) -> bool:
        """Fused compute is fp32 by contract: fp32 parameters, or bf16
        parameters whose fp32 truth is a master weight."""
        return p.dtype == torch.float32 or (
            self._multi_precision and p.dtype == torch.bfloat16)

    def _fused_step(self, params_grads, lr):
        """Groups eligible parameters by (dtype, lr multiplier, decay
        on), packs each group into one bucket and runs one kernel pass
        per bucket; moments and masters persist in bucket form under the
        "fused_m"/"fused_v"/"fused_master" slots. Returns the pairs it
        does not cover (bf16 parameters without a master)."""
        idx_of = {id(p): i for i, p in enumerate(self._parameter_list)}
        groups: Dict = {}
        leftover = []
        for p, g in params_grads:
            if not self._fused_eligible(p):
                leftover.append((p, g))
                continue
            idx = idx_of[id(p)]
            key = (p.dtype, float(getattr(p, "_lr_scale", 1.0)),
                   self._decay_on(idx, p))
            groups.setdefault(key, []).append((idx, p, g))
        if not groups:
            return leftover
        ordered = sorted(groups.items(), key=lambda kv: kv[1][0][0])

        def signature(uid, members):
            return (uid, tuple((idx, tuple(p.shape))
                               for idx, p, _ in members))

        # geometry guard: a changed group (new or lost grads, shapes, uid
        # shift) or a vanished one de-bucketizes everything back to the
        # canonical slots and rebuilds; moments survive the migration
        rebuild = bool(set(self._fused_buckets) - {k for k, _ in ordered})
        for uid, (key, members) in enumerate(ordered):
            rec = self._fused_buckets.get(key)
            if rec is not None and rec["sig"] != signature(uid, members):
                rebuild = True
        if rebuild:
            self._drop_fused_buckets(debucketize=True)

        for uid, (key, members) in enumerate(ordered):
            param_dtype, lr_mult, decay_on = key
            rec = self._fused_buckets.get(key)
            if rec is None:
                rec = {"uid": uid, "sig": signature(uid, members),
                       "layout": build_bucket_layout(
                           [(idx, tuple(p.shape)) for idx, p, _ in members])}
                self._fused_buckets[key] = rec
            layout = rec["layout"]
            has_master = param_dtype != torch.float32
            mdtype = self._moment_dtype if self._moment_dtype is not None \
                else torch.float32
            self._seed_fused_bucket(uid, layout, members, mdtype, has_master)
            g_bucket = pack_bucket([g for _, _, g in members], layout,
                                   param_dtype)
            if has_master:
                w_bucket = self._accumulators["fused_master"][uid]
            else:
                w_bucket = pack_bucket([p.detach() for _, p, _ in members],
                                       layout, torch.float32)
            scalars = adamw_scalars(lr * lr_mult, self._beta1, self._beta2,
                                    self._eps,
                                    self._wd if decay_on else 0.0,
                                    self._step_count,
                                    device=g_bucket.device)
            p_new, _, _, _ = fused_adamw_bucket(
                g_bucket, w_bucket, self._accumulators["fused_m"][uid],
                self._accumulators["fused_v"][uid], scalars,
                param_dtype=param_dtype if has_master else None)
            del g_bucket
            for arr, (_, p, _) in zip(unpack_bucket(p_new, layout),
                                      members):
                p.detach().copy_(arr)
        return leftover

    def _seed_fused_bucket(self, uid, layout, members, mdtype, has_master):
        """Materialize a group's m/v (+ master) buckets if absent: from
        the canonical per-parameter slots where present (checkpoint
        reload, migration from the per-parameter path), else zeros / the
        parameters in fp32. Consumed canonical entries are removed so
        state never exists twice."""
        shape = (layout.rows, LANES)
        device = members[0][1].device
        for slot_name, canon in (("fused_m", "moment1"),
                                 ("fused_v", "moment2")):
            slot = self._accumulators.setdefault(slot_name, {})
            cur = slot.get(uid)
            if cur is not None and tuple(cur.shape) == shape \
                    and cur.dtype == mdtype:
                continue
            canon_slot = self._accumulators.get(canon, {})
            prev = [canon_slot.pop(idx, None) for idx, _, _ in members]
            if all(x is None for x in prev):
                slot[uid] = torch.zeros(shape, dtype=mdtype, device=device)
            else:
                slot[uid] = pack_bucket(
                    [torch.zeros(p.shape, dtype=mdtype, device=device)
                     if x is None else x for x, (_, p, _) in
                     zip(prev, members)], layout, mdtype)
        if has_master:
            w_slot = self._accumulators.setdefault("fused_master", {})
            cur = w_slot.get(uid)
            if cur is None or tuple(cur.shape) != shape:
                parts = []
                for idx, p, _ in members:
                    prev = self._master_weights.pop(idx, None)
                    parts.append(p.detach() if prev is None else prev)
                w_slot[uid] = pack_bucket(parts, layout, torch.float32)
