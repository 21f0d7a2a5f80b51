"""The port's training-loop pieces against the reference on the CPU:
the 17 LR schedulers, gradient clipping, and every optimizer of the zoo.

* Each scheduler's lr over 30 steps equals the reference's to 1e-12
  (`ReduceOnPlateau` on a seeded metric sequence with plateaus); its
  state_dict equals the reference's and round-trips mid-run.
* The three clip classes and the two clip functions on fp32 and bf16
  gradients: fp32 within 1e-6, bf16 within one bf16 ulp.
* A 5-step trajectory of every optimizer (amsgrad, L1Decay / L2Decay,
  a scheduler, clip objects and LBFGS's closure included) from the same
  weights and gradients, fp32, within 1e-5; fused AdamW with two
  `lr_ratio` buckets, a warm-up + cosine scheduler and
  ClipGradByGlobalNorm against the reference's fused AdamW (its buckets
  are below the size at which it calls its Pallas kernel, so it runs
  the same update through XLA: no interpret mode here).
* The reference's "clip sees fp32 upcasts whatever `moment_dtype`"
  property (tests/test_fused_optimizer.py): one clipped step is bitwise
  the same for every moment dtype, fused or not.
* `models/convert.py` carries amsgrad's accumulator and the scheduler's
  state from a reference checkpoint.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.models.convert import from_jax_optimizer_state
import paddle_tpu.regularizer as jreg

SHAPES = [(16, 8), (8,), (16, 8)]
STEPS = 5


# ------------------------------------------------------------ schedulers
SCHEDULERS = [
    ("NoamDecay", (64, 10), dict(learning_rate=2.0)),
    ("PiecewiseDecay", ([5, 12, 20], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("InverseTimeDecay", (0.5, 0.2), {}),
    ("PolynomialDecay", (0.5, 12), dict(end_lr=0.01, power=2.0)),
    ("PolynomialDecay", (0.5, 7), dict(end_lr=0.01, cycle=True)),
    ("LinearWarmup", (0.3, 6, 0.0, 0.3), {}),
    ("ExponentialDecay", (0.5, 0.9), {}),
    ("MultiStepDecay", (0.5, [4, 9, 17]), dict(gamma=0.5)),
    ("StepDecay", (0.5, 4), dict(gamma=0.7)),
    ("LambdaDecay", (0.5, lambda e: 0.95 ** e), {}),
    ("MultiplicativeDecay", (0.5, lambda e: 0.9 if e % 2 else 1.0), {}),
    ("CosineAnnealingDecay", (0.5, 11), dict(eta_min=0.01)),
    ("CosineAnnealingWarmRestarts", (0.5, 4), dict(T_mult=2, eta_min=0.02)),
    ("ReduceOnPlateau", (0.5,), dict(factor=0.5, patience=2, cooldown=1,
                                     min_lr=0.01)),
    ("ReduceOnPlateau", (0.5,), dict(mode="max", threshold=0.05,
                                     threshold_mode="abs", patience=1)),
    ("LinearLR", (0.5, 10), dict(start_factor=0.2)),
    ("OneCycleLR", (0.5, 25), dict(phase_pct=0.3)),
    ("OneCycleLR", (0.5, 25), dict(anneal_strategy="linear")),
    ("CyclicLR", (0.05, 0.5, 4), dict(step_size_down=6)),
    ("CyclicLR", (0.05, 0.5, 3), dict(mode="triangular2")),
    ("CyclicLR", (0.05, 0.5, 3), dict(mode="exp_range", exp_gamma=0.9)),
    ("CyclicLR", (0.05, 0.5, 3), dict(scale_fn=lambda c: 1.0 / c)),
]


def _metrics(seed=3, n=30):
    """A seeded metric sequence with plateaus (ReduceOnPlateau)."""
    rng = np.random.RandomState(seed)
    return np.repeat(np.cumsum(rng.randn(n // 3)), 3) + 0.01 * rng.randn(n)


def _step(sched, metric):
    if type(sched).__name__ == "ReduceOnPlateau":
        sched.step(metric)
    else:
        sched.step()


def _warmup_cosine(mod):
    return mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(0.3, T_max=6),
                               warmup_steps=2, start_lr=0.0, end_lr=0.3)


@pytest.mark.parametrize("case", SCHEDULERS + [("warmup_cosine", (), {})],
                         ids=lambda c: c[0])
def test_scheduler_lr_and_state_match_reference(case):
    name, args, kw = case
    if name == "warmup_cosine":
        ref, port = _warmup_cosine(jopt), _warmup_cosine(topt)
        fresh = _warmup_cosine(topt)
    else:
        ref = getattr(jopt.lr, name)(*args, **kw)
        port = getattr(topt.lr, name)(*args, **kw)
        fresh = getattr(topt.lr, name)(*args, **kw)
    assert set(topt.lr.__all__) == set(jopt.lr.__all__)
    for i, metric in enumerate(_metrics()):
        assert abs(port() - ref()) <= 1e-12 * max(1.0, abs(ref())), i
        if i == 15:
            state = port.state_dict()
            assert state == ref.state_dict()
            fresh.set_state_dict(state)
            assert fresh() == port()
        _step(ref, metric)
        _step(port, metric)
        if i >= 15:
            _step(fresh, metric)
            assert fresh() == port(), i
    assert port.state_dict() == ref.state_dict()


# ----------------------------------------------------------------- clip
def _grads(dtype, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(dtype) for s in SHAPES]


def _ref_pairs(arrays, dtype):
    ps = [paddle.create_parameter(list(a.shape), dtype) for a in arrays]
    return [(p, paddle.to_tensor(a)) for p, a in zip(ps, arrays)]


def _port_pairs(arrays, dtype):
    return [(torch.nn.Parameter(torch.zeros(a.shape, dtype=dtype)),
             _t(a)) for a in arrays]


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_close(got, want, bf16):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if bf16:
        ulp = np.spacing(np.abs(want).astype(ml_dtypes.bfloat16)) \
            .astype(np.float32)
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


CLIPS = [("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (50.0,)),
         ("ClipGradByNorm", (1.5,)), ("ClipGradByValue", (0.5,)),
         ("ClipGradByValue", (0.5, -0.2))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", CLIPS, ids=lambda c: f"{c[0]}{c[1]}")
def test_clip_classes_match_reference(clip, dtype):
    name, args = clip
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    arrays = _grads(npdt, seed=len(args))
    want = getattr(jnn, name)(*args)(_ref_pairs(arrays, dtype))
    got = getattr(tnn, name)(*args)(_port_pairs(arrays, getattr(torch,
                                                                dtype)))
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _assert_close(g, np.asarray(w._data, np.float32), dtype != "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn,args", [("clip_grad_norm_", (1.0,)),
                                     ("clip_grad_norm_", (0.5, 1.0)),
                                     ("clip_grad_norm_", (0.5, float("inf"))),
                                     ("clip_grad_value_", (0.3,))])
def test_clip_functions_match_reference(fn, args, dtype):
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    arrays = _grads(npdt, seed=7)
    ref = [p for p, _ in _ref_pairs(arrays, dtype)]
    for p, a in zip(ref, arrays):
        p.grad = paddle.to_tensor(a)
    port = [p for p, _ in _port_pairs(arrays, getattr(torch, dtype))]
    for p, a in zip(port, arrays):
        p.grad = _t(a)
    total_ref = getattr(jnn.clip, fn)(ref, *args)
    total = getattr(tnn, fn)(port, *args)
    if total_ref is not None:
        np.testing.assert_allclose(total.float().numpy(),
                                   np.asarray(total_ref._data, np.float32),
                                   rtol=1e-6 if dtype == "float32" else 1e-2)
    for p, r in zip(port, ref):
        _assert_close(p.grad, np.asarray(r._grad_buffer, np.float32),
                      dtype != "float32")


# ------------------------------------------------------------ the zoo
def _ratio(params):
    """lr_ratio by parameter position: 0.5 for the first, 1 for the
    rest."""
    ids = [id(p) for p in params]
    return lambda p: 0.5 if ids.index(id(p)) == 0 else 1.0


ZOO = {
    "SGD_l2": lambda m, ps, r: m.SGD(0.1, parameters=ps, weight_decay=0.01),
    "SGD_L1Decay": lambda m, ps, r: m.SGD(
        0.1, parameters=ps, weight_decay=r.L1Decay(0.02)),
    "Momentum": lambda m, ps, r: m.Momentum(0.05, 0.9, parameters=ps),
    "Momentum_nesterov_L2Decay": lambda m, ps, r: m.Momentum(
        0.05, 0.9, parameters=ps, use_nesterov=True,
        weight_decay=r.L2Decay(0.01)),
    "Adam": lambda m, ps, r: m.Adam(1e-2, parameters=ps, weight_decay=0.01),
    "Adam_amsgrad_L1Decay": lambda m, ps, r: m.Adam(
        1e-2, parameters=ps, amsgrad=True, weight_decay=r.L1Decay(0.01)),
    "Adam_StepDecay_ClipGradByNorm": lambda m, ps, r: m.Adam(
        m.lr.StepDecay(1e-2, 2, 0.5), parameters=ps,
        grad_clip=_clip(m).ClipGradByNorm(0.05)),
    "AdamW_amsgrad_L2Decay": lambda m, ps, r: m.AdamW(
        1e-2, parameters=ps, amsgrad=True, weight_decay=r.L2Decay(0.05)),
    "AdamW_lr_ratio_ClipGradByValue": lambda m, ps, r: m.AdamW(
        1e-2, parameters=ps, lr_ratio=_ratio(ps),
        grad_clip=_clip(m).ClipGradByValue(0.02)),
    "AdamW_amsgrad_fused_flag": lambda m, ps, r: m.AdamW(
        1e-2, parameters=ps, amsgrad=True, fused=True),
    "Adagrad": lambda m, ps, r: m.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1),
    "Adadelta": lambda m, ps, r: m.Adadelta(1.0, rho=0.9, parameters=ps),
    "Adamax": lambda m, ps, r: m.Adamax(1e-2, parameters=ps),
    "RMSProp": lambda m, ps, r: m.RMSProp(1e-2, parameters=ps),
    "RMSProp_centered_momentum": lambda m, ps, r: m.RMSProp(
        1e-2, momentum=0.9, centered=True, parameters=ps),
    "Lamb": lambda m, ps, r: m.Lamb(
        1e-2, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
    "NAdam": lambda m, ps, r: m.NAdam(1e-2, parameters=ps),
    "RAdam": lambda m, ps, r: m.RAdam(1e-2, parameters=ps),
    "ASGD": lambda m, ps, r: m.ASGD(0.1, parameters=ps),
    "Rprop": lambda m, ps, r: m.Rprop(1e-2, parameters=ps),
}


def _clip(mod):
    return jnn if mod is jopt else tnn


def _init(seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _ref_params(init):
    ps = [paddle.create_parameter(list(a.shape), "float32") for a in init]
    for p, a in zip(ps, init):
        p.set_value(a)
    return ps


def _port_params(init):
    return [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]


def _trajectory(name, steps=STEPS):
    init = _init()
    ref, port = _ref_params(init), _port_params(init)
    ref_opt = ZOO[name](jopt, ref, jreg)
    port_opt = ZOO[name](topt, port, treg)
    rng = np.random.RandomState(5)
    for _ in range(steps):
        grads = [(0.1 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
        for p, q, g in zip(ref, port, grads):
            p.grad = paddle.to_tensor(g)
            q.grad = torch.from_numpy(g)
        ref_opt.step()
        port_opt.step()
        for o in (ref_opt, port_opt):
            if not isinstance(o._learning_rate, float):
                o._learning_rate.step()
    return ref, port, ref_opt, port_opt


@pytest.mark.parametrize("name", sorted(ZOO))
def test_optimizer_trajectory_matches_reference(name):
    ref, port, ref_opt, port_opt = _trajectory(name)
    for p, q in zip(ref, port):
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(p._data),
                                   rtol=1e-5, atol=1e-5)
    rs, ps = ref_opt.state_dict(), port_opt.state_dict()
    assert set(rs) == set(ps)
    for k in rs:
        if k == "LR_Scheduler":
            assert ps[k] == rs[k]
        elif k != "@step":
            np.testing.assert_allclose(ps[k].numpy(), np.asarray(rs[k]._data),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def _closure(params, opt, lib):
    """A smooth non-quadratic loss of the parameters, gradients cleared
    and recomputed (LBFGS's closure)."""
    targets = [np.linspace(-1, 1, int(np.prod(s)), dtype=np.float32)
               .reshape(s) for s in SHAPES]

    def closure():
        opt.clear_grad()
        loss = None
        for p, t in zip(params, targets):
            t = paddle.to_tensor(t) if lib == "ref" else torch.from_numpy(t)
            d = p - t
            term = (d * d + 0.1 * d * d * d * d).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        return loss
    return closure


def test_lbfgs_trajectory_matches_reference():
    init = _init()
    ref, port = _ref_params(init), _port_params(init)
    ref_opt = jopt.LBFGS(0.2, history_size=3, parameters=ref)
    port_opt = topt.LBFGS(0.2, history_size=3, parameters=port)
    rc, pc = _closure(ref, ref_opt, "ref"), _closure(port, port_opt, "port")
    for _ in range(STEPS):
        ref_opt.step(rc)
        port_opt.step(pc)
    # the reference's history stays empty (its next step's s is zero:
    # _prev_flat holds the weights it wrote); the port keeps that rule
    assert len(port_opt._s_hist) == len(ref_opt._s_hist)
    for p, q in zip(ref, port):
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(p._data),
                                   rtol=1e-5, atol=1e-5)


def _fused_adamw(mod, params):
    return mod.AdamW(_warmup_cosine(mod), parameters=params,
                     weight_decay=0.05, lr_ratio=_ratio(params),
                     grad_clip=_clip(mod).ClipGradByGlobalNorm(0.5),
                     fused=True)


def test_fused_adamw_lr_ratio_scheduler_clip_matches_reference():
    """Two lr ratios make two buckets on both sides; the scheduled lr
    and the global-norm clip reach the fused update; 5 steps within
    1e-5, and the same canonical state keys."""
    init = _init(13)
    ref, port = _ref_params(init), _port_params(init)
    ref_opt, port_opt = _fused_adamw(jopt, ref), _fused_adamw(topt, port)
    rng = np.random.RandomState(17)
    for _ in range(STEPS):
        grads = [rng.randn(*s).astype(np.float32) for s in SHAPES]
        for p, q, g in zip(ref, port, grads):
            p.grad = paddle.to_tensor(g)
            q.grad = torch.from_numpy(g)
        ref_opt.step()
        port_opt.step()
        ref_opt._learning_rate.step()
        port_opt._learning_rate.step()
        assert len(port_opt._fused_buckets) == len(ref_opt._fused_buckets) \
            == 2
    for p, q in zip(ref, port):
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(p._data),
                                   rtol=1e-5, atol=1e-5)
    rs, ps = ref_opt.state_dict(), port_opt.state_dict()
    assert set(rs) == set(ps) and ps["LR_Scheduler"] == rs["LR_Scheduler"]


def test_fused_bucket_group_change_keeps_moments():
    """A group that vanishes (its lr ratio changes) de-bucketizes and
    rebuilds with the moments intact: the fused trajectory stays
    bitwise the per-parameter one."""
    init = _init(19)
    ratios = {"now": 0.5}
    a, b = _port_params(init), _port_params(init)

    def make(ps, fused):
        first = id(ps[0])
        return topt.AdamW(1e-2, parameters=ps, fused=fused,
                          lr_ratio=lambda p: ratios["now"]
                          if id(p) == first else 1.0)
    fused, plain = make(a, True), make(b, False)
    rng = np.random.RandomState(23)
    for step in range(4):
        ratios["now"] = 0.5 if step < 2 else 1.0
        grads = [rng.randn(*s).astype(np.float32) for s in SHAPES]
        for p, q, g in zip(a, b, grads):
            p.grad = torch.from_numpy(g)
            q.grad = torch.from_numpy(g.copy())
        fused.step()
        plain.step()
        assert len(fused._fused_buckets) == (2 if step < 2 else 1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_clip_sees_fp32_whatever_the_moment_dtype():
    """The reference's TestGradClipInteraction property: with a global-
    norm clip and multi_precision=False, the first step (moments from
    zeros) is bitwise the same for moment_dtype None / bf16, fused or
    not: the clip saw the same fp32 gradients."""
    init = _init(29)
    grads = _grads(np.float32, seed=31, scale=3.0)

    def one_step(moment_dtype, fused):
        ps = _port_params(init)
        opt = topt.AdamW(1e-2, parameters=ps, multi_precision=False,
                         grad_clip=tnn.ClipGradByGlobalNorm(0.1),
                         moment_dtype=moment_dtype, fused=fused)
        for p, g in zip(ps, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        return ps
    want = one_step(None, False)
    for md in (None, "bfloat16"):
        for fused in (False, True):
            for x, y in zip(one_step(md, fused), want):
                assert torch.equal(x, y), (md, fused)


def test_amsgrad_and_scheduler_state_cross_from_reference():
    """A reference Adam(amsgrad) + scheduler checkpoint loads into a
    fresh port optimizer through convert.py; one more step agrees."""
    ref, port, ref_opt, _ = _trajectory("Adam_StepDecay_ClipGradByNorm", 2)
    ams_ref, _, ams_opt, _ = _trajectory("Adam_amsgrad_L1Decay", 2)
    for opt, params, name in ((ref_opt, ref, "Adam_StepDecay_ClipGradByNorm"),
                              (ams_opt, ams_ref, "Adam_amsgrad_L1Decay")):
        np_state = {k: (v if k in ("@step", "LR_Scheduler")
                        else np.asarray(v._data))
                    for k, v in opt.state_dict().items()}
        loaded = _port_params([np.asarray(p._data) for p in params])
        fresh = ZOO[name](topt, loaded, treg)
        fresh.set_state_dict(from_jax_optimizer_state(np_state))
        assert set(fresh.state_dict()) == set(np_state)
        g = [np.full(s, 0.01, np.float32) for s in SHAPES]
        for p, q, a in zip(params, loaded, g):
            p.grad = paddle.to_tensor(a)
            q.grad = torch.from_numpy(a)
        opt.step()
        fresh.step()
        assert fresh.get_lr() == opt.get_lr()
        for p, q in zip(params, loaded):
            np.testing.assert_allclose(q.detach().numpy(),
                                       np.asarray(p._data), rtol=1e-5,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="not ported"):
        from_jax_optimizer_state({"bogus_0": np.zeros(2)})


def test_set_lr_and_minimize():
    ps = _port_params(_init())
    opt = topt.SGD(topt.lr.StepDecay(0.1, 1), parameters=ps)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    opt.set_lr_scheduler(0.25)
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    loss = sum((p * p).sum() for p in ps)
    before = [p.detach().clone() for p in ps]
    ops, pg = opt.minimize(loss)
    assert ops == [] and len(pg) == len(ps)
    for p, b0, (_, g) in zip(ps, before, pg):
        assert p.grad is g
        torch.testing.assert_close(p.detach(), b0 - 0.5 * 2 * b0)
    with pytest.raises(TypeError, match="L1Decay"):
        topt.AdamW(parameters=ps, weight_decay=treg.L1Decay(0.1))
