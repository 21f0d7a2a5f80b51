"""Optimizer base and the optimizer zoo (port of
`paddle_tpu/optimizer/optimizer.py`).

Parameters are `torch.nn.Parameter`s; `step()` reads their `.grad` and
writes the updated values into them in place. A step runs, in order:
`grad_clip` (an `nn.clip` object) on the raw gradients, before any
accumulator is touched; the learning rate, a float or an `LRScheduler`
read at every step (the caller steps the scheduler); then each
parameter's update at that lr times its `_lr_scale` attribute (default
1). `weight_decay` is a float (coupled L2: g + wd * w) or a regularizer
(`regularizer.L1Decay` / `L2Decay`); AdamW applies its own decoupled
decay instead. `multi_precision=True` keeps an fp32 master weight for
every non-fp32 parameter; `moment_dtype="bfloat16"` stores every
accumulator in bf16 while the update math runs in fp32 (upcast on read,
round on store).

`AdamW(..., fused=True)` packs every eligible parameter into one padded
(rows, 128) bucket per (dtype, lr multiplier, decay on) group, where the
multiplier is `_lr_scale` times `lr_ratio(p)`, and runs each bucket's
update as one pass of `kernels/fused_optimizer.py`'s kernel (one read
and one write per state byte): two lr ratios make two buckets, two
launches a step. Moments and master weights then LIVE in bucket form
and are updated in place; `state_dict()` de-bucketizes them to the
canonical per-parameter keys `moment1_<i>`, `moment2_<i>`, `master_<i>`
and `@step`, the reference's, so a checkpoint crosses between fused and
per-parameter optimizers and from the reference
(`models/convert.py::from_jax_optimizer_state`); `set_state_dict`
re-buckets lazily at the next step, and a group that appears or
vanishes de-bucketizes every group and rebuilds with the moments
intact. Eligible: fp32 parameters, or bf16 parameters under
multi_precision; `amsgrad` keeps the per-parameter path. For an fp32
weight the per-parameter `_apply_one` runs the fused update's own
expression on its scalars, so the two round identically on either
device.

The rest of the zoo (SGD, Momentum, Adam, Adagrad, Adadelta, Adamax,
RMSProp, Lamb, NAdam, RAdam, ASGD, Rprop, LBFGS) updates parameter by
parameter in plain PyTorch, as the reference does: it has no kernel.
LBFGS is the reference's simplified two-loop version with a
closure-driven `step`. A scheduler's state travels in `state_dict()`
under `LR_Scheduler`, amsgrad's accumulator as `moment2_max_<i>`.

Not ported (it raises): ZeRO-1 over a 'sharding' mesh.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..kernels.fused_optimizer import (LANES, _adamw_math, adamw_scalars,
                                       build_bucket_layout,
                                       fused_adamw_bucket, pack_bucket,
                                       unpack_bucket)
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "NAdam", "RAdam", "ASGD",
           "Rprop", "LBFGS"]

# accumulator slots that hold BUCKETED fused state rather than
# per-parameter tensors; state_dict() de-bucketizes them
_FUSED_SLOTS = ("fused_m", "fused_v", "fused_master")


def _dtype(d):
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, moment_dtype=None, fused=None):
        if parameters is None:
            raise ValueError("paddle_tpu_torch optimizers require an "
                             "explicit parameter list (model.parameters())")
        params = list(parameters)
        self._param_groups = None
        if params and isinstance(params[0], dict):
            self._param_groups = params
            params = [p for group in params for p in group["params"]]
        self._parameter_list = params
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = (float(weight_decay)
                              if isinstance(weight_decay, (int, float))
                              else weight_decay)
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
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

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

    def _decayed_grad(self, p, g):
        """Coupled decay: g + wd * w for a float, the regularizer's
        `apply` for a regularizer object."""
        wd = self._weight_decay
        if isinstance(wd, float) and wd != 0.0:
            return g + wd * p.detach().to(g.dtype)
        if wd is not None and hasattr(wd, "apply"):
            return wd.apply(p.detach(), g)
        return g

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
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

    minimize_step = step

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

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """backward + step. Gradients are NOT cleared (the caller owns
        clear_grad()); returns ([], [(param, grad), ...])."""
        loss.backward()
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.grad is not None]
        self.step()
        return [], params_grads

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
        `master_<i>`, `@step`, and the scheduler's `LR_Scheduler`."""
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
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load canonical entries (tensors or numpy arrays), each onto its
        parameter's device, and a scheduler's `LR_Scheduler`. Live
        buckets are de-bucketized first, so a partial state dict
        overwrites only the keys it carries; the fused path re-buckets at
        the next step."""
        self._drop_fused_buckets(debucketize=True)
        for key, v in state.items():
            if key == "@step":
                self._step_count = int(v)
                continue
            if key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(v)
                continue
            name, idx = key.rsplit("_", 1)
            idx = int(idx)
            arr = torch.as_tensor(v).to(self._parameter_list[idx].device)
            if name == "master":
                self._master_weights[idx] = arr
            else:
                self._accumulators.setdefault(name, {})[idx] = arr
        return self


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m = self._master(idx, p)
        self._writeback(idx, p, m - lr * g.to(m.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m = self._master(idx, p)
        g = g.to(m.dtype)
        vel = self._momentum * self._acc("velocity", idx, m) + g
        self._set_acc("velocity", idx, vel)
        update = g + self._momentum * vel if self._nesterov else vel
        self._writeback(idx, p, m - lr * update)


def _adam_moments(opt, idx, m_w, g):
    """Update and store moment1/moment2 of parameter idx with `opt`'s
    betas; returns (m, v)."""
    m = opt._beta1 * opt._acc("moment1", idx, m_w) + (1 - opt._beta1) * g
    v = opt._beta2 * opt._acc("moment2", idx, m_w) \
        + (1 - opt._beta2) * g * g
    opt._set_acc("moment1", idx, m)
    opt._set_acc("moment2", idx, v)
    return m, v


class Adam(Optimizer):
    """Adam with coupled weight decay (a float or a regularizer) and
    optional amsgrad (the running max of the bias-corrected second
    moment, `moment2_max`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False,
                 moment_dtype=None, fused=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, moment_dtype=moment_dtype,
                         fused=fused)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _moments(self, idx, m_w, g):
        """Update and store moment1/moment2 of parameter idx; returns
        (mhat, vhat), vhat through amsgrad's running max when set."""
        t = self._step_count
        m, v = _adam_moments(self, idx, m_w, g)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        if self._amsgrad:
            vhat = torch.maximum(self._acc("moment2_max", idx, m_w), vhat)
            self._set_acc("moment2_max", idx, vhat)
        return mhat, vhat

    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m_w = self._master(idx, p)
        mhat, vhat = self._moments(idx, m_w, g.to(m_w.dtype))
        self._writeback(idx, p,
                        m_w - lr * mhat / (torch.sqrt(vhat) + self._eps))


class AdamW(Adam):
    """Adam with decoupled weight decay (reference:
    python/paddle/optimizer/adamw.py). `weight_decay` is a float or an
    L2Decay (its coefficient); L1Decay raises TypeError. `lr_ratio(p)`
    scales each parameter's lr. `lazy_mode` and `name` are accepted and,
    as in the reference, change nothing for dense gradients."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, moment_dtype=None, fused=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad,
                         moment_dtype=moment_dtype, fused=fused)
        if isinstance(weight_decay, L1Decay):
            raise TypeError("AdamW applies decoupled L2 decay; L1Decay is "
                            "not supported (use Adam with "
                            "weight_decay=L1Decay(...))")
        if isinstance(weight_decay, L2Decay):
            weight_decay = weight_decay.coeff
        self._wd = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_fn = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        self._scalar_cache = (None, {})

    def _decay_on(self, idx, p) -> bool:
        return self._wd != 0.0 and (
            self._apply_decay_fn is None
            or self._apply_decay_fn(getattr(p, "name", None)
                                    or f"param_{idx}"))

    def _apply_one(self, idx, p, g, lr):
        """One parameter's update. An fp32 weight (fp32 parameter or
        master) without amsgrad runs the fused path's own expression,
        `_adamw_math`, on the fused path's nine scalars, so the two paths
        round alike on either device (on the card a division by a Python
        scalar is a multiplication by its reciprocal); the rest runs the
        reference's chain of ops in the weight's dtype."""
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        m_w = self._master(idx, p)
        decay = self._wd if self._decay_on(idx, p) else 0.0
        if m_w.dtype == torch.float32 and not self._amsgrad:
            w, m, v = _adamw_math(g, m_w, self._acc("moment1", idx, m_w),
                                  self._acc("moment2", idx, m_w),
                                  *self._step_scalars(lr, decay, m_w.device))
            self._set_acc("moment1", idx, m)
            self._set_acc("moment2", idx, v)
            self._writeback(idx, p, w)
            return
        if decay:
            m_w = m_w * (1.0 - lr * decay)
        mhat, vhat = self._moments(idx, m_w, g.to(m_w.dtype))
        self._writeback(idx, p,
                        m_w - lr * mhat / (torch.sqrt(vhat) + self._eps))

    def _step_scalars(self, lr, decay, device):
        """The fused path's nine scalars for this step, built once per
        (lr, decay, device): one host-to-device copy a step for each
        distinct pair, not one per parameter."""
        step, cache = self._scalar_cache
        if step != self._step_count:
            cache = {}
            self._scalar_cache = (self._step_count, cache)
        key = (lr, decay, device)
        if key not in cache:
            cache[key] = adamw_scalars(lr, self._beta1, self._beta2,
                                       self._eps, decay, self._step_count,
                                       device=device).unbind()
        return cache[key]

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
        does not cover (bf16 parameters without a master; everything
        under amsgrad)."""
        if self._amsgrad:
            return params_grads
        idx_of = {id(p): i for i, p in enumerate(self._parameter_list)}
        groups: Dict = {}
        leftover = []
        for p, g in params_grads:
            if not self._fused_eligible(p):
                leftover.append((p, g))
                continue
            idx = idx_of[id(p)]
            lr_mult = float(getattr(p, "_lr_scale", 1.0))
            if self._lr_ratio is not None:
                lr_mult *= float(self._lr_ratio(p))
            key = (p.dtype, lr_mult, self._decay_on(idx, p))
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


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m_w = self._master(idx, p)
        g = g.to(m_w.dtype)
        acc = self._acc("moment", idx, m_w, fill=self._init_acc) + g * g
        self._set_acc("moment", idx, acc)
        self._writeback(idx, p, m_w - lr * g / (torch.sqrt(acc) + self._eps))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._eps, self._rho = epsilon, rho

    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m_w = self._master(idx, p)
        g = g.to(m_w.dtype)
        avg_sq = self._acc("avg_squared_grad", idx, m_w)
        avg_up = self._acc("avg_squared_update", idx, m_w)
        avg_sq = self._rho * avg_sq + (1 - self._rho) * g * g
        update = -torch.sqrt((avg_up + self._eps) / (avg_sq + self._eps)) * g
        avg_up = self._rho * avg_up + (1 - self._rho) * update * update
        self._set_acc("avg_squared_grad", idx, avg_sq)
        self._set_acc("avg_squared_update", idx, avg_up)
        self._writeback(idx, p, m_w + lr * update)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m_w = self._master(idx, p)
        g = g.to(m_w.dtype)
        m = self._beta1 * self._acc("moment", idx, m_w) \
            + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * self._acc("inf_norm", idx, m_w),
                          torch.abs(g))
        self._set_acc("moment", idx, m)
        self._set_acc("inf_norm", idx, u)
        t = self._step_count
        self._writeback(idx, p, m_w - lr / (1 - self._beta1 ** t) * m
                        / (u + self._eps))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m_w = self._master(idx, p)
        g = g.to(m_w.dtype)
        ms = self._rho * self._acc("mean_square", idx, m_w) \
            + (1 - self._rho) * g * g
        mom = self._acc("momentum", idx, m_w)
        self._set_acc("mean_square", idx, ms)
        if self._centered:
            mg = self._rho * self._acc("mean_grad", idx, m_w) \
                + (1 - self._rho) * g
            self._set_acc("mean_grad", idx, mg)
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * mom + lr * g / denom
        self._set_acc("momentum", idx, mom)
        self._writeback(idx, p, m_w - mom)


class Lamb(Optimizer):
    """Layer-wise adaptive Adam (reference: python/paddle/optimizer/
    lamb.py): the Adam direction plus decay, scaled by ||w|| / ||r||."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_one(self, idx, p, g, lr):
        m_w = self._master(idx, p)
        t = self._step_count
        m, v = _adam_moments(self, idx, m_w, g.to(m_w.dtype))
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._eps)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        r = r + wd * m_w
        w_norm = torch.linalg.vector_norm(m_w)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        self._writeback(idx, p, m_w - lr * trust * r)


class NAdam(Adam):
    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m_w = self._master(idx, p)
        g = g.to(m_w.dtype)
        t = self._step_count
        m, v = _adam_moments(self, idx, m_w, g)
        mhat = self._beta1 * m / (1 - self._beta1 ** (t + 1)) + \
            (1 - self._beta1) * g / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        self._writeback(idx, p,
                        m_w - lr * mhat / (torch.sqrt(vhat) + self._eps))


class RAdam(Adam):
    def _apply_one(self, idx, p, g, lr):
        g = self._decayed_grad(p, g)
        m_w = self._master(idx, p)
        t = self._step_count
        m, v = _adam_moments(self, idx, m_w, g.to(m_w.dtype))
        mhat = m / (1 - self._beta1 ** t)
        rho_inf = 2 / (1 - self._beta2) - 1
        rho_t = rho_inf - 2 * t * self._beta2 ** t / (1 - self._beta2 ** t)
        if rho_t > 4:
            vhat = torch.sqrt(v / (1 - self._beta2 ** t))
            rt = ((rho_t - 4) * (rho_t - 2) * rho_inf /
                  ((rho_inf - 4) * (rho_inf - 2) * rho_t)) ** 0.5
            self._writeback(idx, p, m_w - lr * rt * mhat / (vhat + self._eps))
        else:
            self._writeback(idx, p, m_w - lr * mhat)


class ASGD(SGD):
    """The reference's ASGD: `batch_num` is accepted, the update is
    SGD's."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)


class Rprop(Optimizer):
    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _apply_one(self, idx, p, g, lr):
        m_w = self._master(idx, p)
        g = g.to(m_w.dtype)
        prev_g = self._acc("prev_grad", idx, m_w)
        step = self._acc("step_size", idx, m_w, fill=self.get_lr())
        sign = torch.sign(g * prev_g)
        step = torch.where(
            sign > 0, torch.clamp(step * self._etas[1],
                                  max=self._lr_range[1]),
            torch.where(sign < 0, torch.clamp(step * self._etas[0],
                                              min=self._lr_range[0]), step))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        self._set_acc("prev_grad", idx, g_eff)
        self._set_acc("step_size", idx, step)
        self._writeback(idx, p, m_w - torch.sign(g_eff) * step)


class LBFGS(Optimizer):
    """The reference's simplified LBFGS: one step along the two-loop
    direction over the flattened fp32 parameters, with a history of up
    to `history_size` (s, y) pairs. `step(closure)` calls the closure
    (forward + backward) with gradients enabled first."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-07, tolerance_change=1e-09,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._history_size = history_size
        self._s_hist: List = []
        self._y_hist: List = []
        self._prev_flat = None
        self._prev_grad = None

    def step(self, closure=None):
        if closure is not None:
            with torch.enable_grad():
                closure()
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        if not params:
            return None
        with torch.no_grad():
            self._two_loop_step(params)
        return None

    def _two_loop_step(self, params):
        flat_g = torch.cat([p.grad.float().reshape(-1) for p in params])
        flat_w = torch.cat([p.detach().float().reshape(-1) for p in params])
        if self._prev_flat is not None:
            s = flat_w - self._prev_flat
            y = flat_g - self._prev_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self._history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
        q = flat_g
        alphas = []
        for s, y in zip(reversed(self._s_hist), reversed(self._y_hist)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._s_hist:
            s, y = self._s_hist[-1], self._y_hist[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        self._prev_flat = flat_w + self.get_lr() * -q
        self._prev_grad = flat_g
        off = 0
        for p in params:
            n = p.numel()
            p.detach().copy_(self._prev_flat[off:off + n].view(p.shape))
            off += n
