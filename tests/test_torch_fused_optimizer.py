"""The port's fused AdamW (kernels/fused_optimizer.py, optimizer/
optimizer.py) against the reference on the CPU.

* Bucket geometry, packing and the nine scalars are the reference's,
  exactly.
* The plain `fused_adamw_bucket` (what a CPU bucket runs) against the
  reference's Pallas kernel in interpret mode, for fp32 state, bf16
  moments, and bf16 parameters with an fp32 master. Not bitwise: XLA's
  CPU code contracts `b1*m + omb1*g` (and the other products feeding a
  sum) into FMAs, where the port rounds each op as separate PyTorch ops
  do (and as its CUDA kernel does, bitwise, on the card). So each fp32
  output is held within one ulp of the largest of its last sum's two
  operands and the sum itself, and each bf16 output within one bf16
  ulp.
* The port's fused and per-parameter updates are bitwise equal.
* state_dict keys are the reference's, and a reference checkpoint loads
  through `models/convert.py::from_jax_optimizer_state`.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import fused_optimizer as ref_fo
from paddle_tpu_torch.kernels import fused_optimizer as fo
from paddle_tpu_torch.models.convert import from_jax_optimizer_state
from paddle_tpu_torch.optimizer import AdamW

LEAVES = [[(0, (33, 7)), (2, (64,)), (5, ())],
          [(1, (128, 256)), (3, (7, 5, 3)), (4, (1,))],
          [(0, (10000,))]]


@pytest.mark.parametrize("leaves", LEAVES, ids=str)
def test_bucket_layout_and_packing_match_reference(leaves):
    ref = ref_fo.build_bucket_layout(leaves)
    got = fo.build_bucket_layout(leaves)
    assert got.entries == ref.entries and got.rows == ref.rows
    assert (got.padded_size, got.used_size) == (ref.padded_size,
                                                ref.used_size)
    rng = np.random.RandomState(0)
    arrays = [np.array(rng.randn(*shape), np.float32)
              for _, shape in leaves]
    want = ref_fo.pack_bucket([jnp.asarray(a) for a in arrays], ref,
                              jnp.bfloat16)
    packed = fo.pack_bucket([torch.from_numpy(a) for a in arrays], got,
                            torch.bfloat16)
    np.testing.assert_array_equal(packed.float().numpy(),
                                  np.asarray(want, np.float32))
    for a, back in zip(arrays, fo.unpack_bucket(packed.float(), got)):
        np.testing.assert_array_equal(
            back.numpy(), a.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("lr,wd,step", [(3e-4, 0.01, 1), (1e-3, 0.0, 7),
                                        (0.1, 0.1, 1000)])
def test_adamw_scalars_bitwise_equal_reference(lr, wd, step):
    want = np.asarray(ref_fo.adamw_scalars(lr, 0.9, 0.999, 1e-8, wd, step))
    got = fo.adamw_scalars(lr, 0.9, 0.999, 1e-8, wd, step).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert fo.adamw_update_bytes(10, 2, 2, True, 2) == \
        ref_fo.adamw_update_bytes(10, 2, 2, True, 2) == 10 * 20


def _ulp(*terms):
    """fp32 ulp of the largest |term|, elementwise: the terms of a sum
    and the sum."""
    big = np.max(np.abs(np.stack([np.asarray(t, np.float32)
                                  for t in terms])), axis=0)
    return np.spacing(big.astype(np.float32))


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.spacing(x.astype(ml_dtypes.bfloat16)).astype(np.float32)


@pytest.mark.parametrize("mode", ["fp32", "bf16_moments", "bf16_master"])
def test_plain_bucket_update_matches_reference_kernel(mode):
    rows = 2 * fo.ROW_ALIGN
    rng = np.random.RandomState(1)
    g = (1e-2 * rng.randn(rows, fo.LANES)).astype(np.float32)
    w = rng.randn(rows, fo.LANES).astype(np.float32)
    m = (1e-3 * rng.randn(rows, fo.LANES)).astype(np.float32)
    v = (1e-4 * np.abs(rng.randn(rows, fo.LANES))).astype(np.float32)
    gdt, mdt = np.float32, np.float32
    if mode == "bf16_moments":
        mdt = ml_dtypes.bfloat16
    if mode == "bf16_master":
        gdt = ml_dtypes.bfloat16
    g, m, v = g.astype(gdt), m.astype(mdt), v.astype(mdt)
    lr, step = 3e-4, 3
    sc_ref = ref_fo.adamw_scalars(lr, 0.9, 0.999, 1e-8, 0.01, step)
    pdt = jnp.bfloat16 if mode == "bf16_master" else None
    want = ref_fo.fused_adamw_bucket(
        jnp.asarray(g), jnp.asarray(w), jnp.asarray(m), jnp.asarray(v),
        sc_ref, param_dtype=pdt, use_pallas=True)

    def tt(a):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a.copy())
    got = fo.fused_adamw_bucket(
        tt(g), tt(w), tt(m), tt(v), fo.adamw_scalars(
            lr, 0.9, 0.999, 1e-8, 0.01, step),
        param_dtype=torch.bfloat16 if pdt is not None else None)
    got = [x.float().numpy() for x in got]
    want = [np.asarray(x, np.float32) for x in want]
    s = np.asarray(sc_ref)
    gf, mf, vf = (a.astype(np.float32) for a in (g, m, v))
    m_new = s[2] * mf + s[3] * gf
    v_new = s[4] * vf + s[5] * gf * gf
    upd = s[0] * (m_new / s[6]) / (np.sqrt(v_new / s[7]) + s[8])
    tol_w = _ulp(w * s[1], upd, w * s[1] - upd)
    tol_m = _ulp(s[2] * mf, s[3] * gf, m_new)
    tol_v = _ulp(s[4] * vf, s[5] * gf * gf, v_new)
    if mdt is not np.float32:
        tol_m, tol_v = _bf16_ulp(m_new), _bf16_ulp(v_new)
    p_tol = _bf16_ulp(want[0]) if pdt is not None else tol_w
    for name, a, b, tol in (("param", got[0], want[0], p_tol),
                            ("weights", got[1], want[1], tol_w),
                            ("m", got[2], want[2], tol_m),
                            ("v", got[3], want[3], tol_v)):
        bad = np.abs(a - b) > tol
        assert not bad.any(), (name, np.abs(a - b).max(), bad.sum())


def _params(seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    shapes = [(48, 48), (48,), (48, 16), (16,)]
    return [torch.nn.Parameter(torch.from_numpy(
        rng.randn(*s).astype(np.float32)).to(dtype)) for s in shapes]


def _run(params, opt, steps, seed=5):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        for p in params:
            p.grad = torch.from_numpy(
                (1e-2 * rng.randn(*p.shape)).astype(np.float32)).to(p.dtype)
        opt.step()
        opt.clear_grad()


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_fused_and_per_parameter_updates_are_bitwise_equal(moment_dtype):
    a, b = _params(0), _params(0)
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              moment_dtype=moment_dtype)
    fused = AdamW(parameters=a, fused=True, **kw)
    plain = AdamW(parameters=b, fused=False, **kw)
    _run(a, fused, 4)
    _run(b, plain, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    sa, sb = fused.state_dict(), plain.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        if k != "@step":
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
    assert fused._fused_buckets and "moment1" not in fused._accumulators


def test_bf16_parameters_with_master_fused_equals_per_parameter():
    a, b = _params(1, torch.bfloat16), _params(1, torch.bfloat16)
    kw = dict(learning_rate=1e-2, multi_precision=True,
              moment_dtype="bfloat16")
    fused = AdamW(parameters=a, fused=True, **kw)
    plain = AdamW(parameters=b, fused=False, **kw)
    _run(a, fused, 3)
    _run(b, plain, 3)
    for x, y in zip(a, b):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
    assert set(fused.state_dict()) == set(plain.state_dict())
    assert all(fused.state_dict()[f"master_{i}"].dtype == torch.float32
               for i in range(len(a)))


def test_state_dict_keys_and_reference_checkpoint_cross():
    """Two fused steps on the reference and the port from the same
    weights and gradients: the same state_dict keys; then the
    reference's state loads into a fresh port optimizer and one more
    step there agrees with one more step of the reference."""
    shapes = [(48, 48), (48,), (48, 16), (16,)]
    rng = np.random.RandomState(9)
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(1e-2 * rng.randn(*s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    ref_params = [paddle.create_parameter(list(s), "float32")
                  for s in shapes]
    for p, a in zip(ref_params, init):
        p.set_value(a)
    ref_opt = paddle.optimizer.AdamW(1e-2, parameters=ref_params,
                                     fused=True, moment_dtype="bfloat16")
    port = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    port_opt = AdamW(1e-2, parameters=port, fused=True,
                     moment_dtype="bfloat16")
    for step in range(2):
        for p, q, g in zip(ref_params, port, grads[step]):
            p.grad = paddle.to_tensor(g)
            q.grad = torch.from_numpy(g)
        ref_opt.step()
        port_opt.step()
    ref_state = ref_opt.state_dict()
    assert set(ref_state) == set(port_opt.state_dict())

    np_state = {k: (v if k == "@step" else np.asarray(v._data))
                for k, v in ref_state.items()}
    loaded = [torch.nn.Parameter(torch.from_numpy(np.array(p._data)))
              for p in ref_params]
    fresh = AdamW(1e-2, parameters=loaded, fused=True,
                  moment_dtype="bfloat16")
    fresh.set_state_dict(from_jax_optimizer_state(np_state))
    for p, q, g in zip(ref_params, loaded, grads[2]):
        p.grad = paddle.to_tensor(g)
        q.grad = torch.from_numpy(g)
    ref_opt.step()
    fresh.step()
    assert fresh._step_count == 3
    for p, q in zip(ref_params, loaded):
        a = np.asarray(p._data)
        np.testing.assert_allclose(q.detach().numpy(), a, rtol=0,
                                   atol=4 * np.spacing(np.abs(a)).max())
    with pytest.raises(ValueError, match="not ported"):
        from_jax_optimizer_state({"moment9_0": np.zeros(2)})


def test_unported_options_raise():
    """ZeRO-1 is still refused; grad_clip, amsgrad and lr_ratio (once
    refused here too) now run (tests/test_torch_optim_zoo.py holds them
    against the reference)."""
    ps = _params(0)
    for kw in (dict(grad_clip=lambda pg: pg), dict(amsgrad=True),
               dict(lr_ratio=lambda p: 1.0)):
        opt = AdamW(1e-3, parameters=ps, **kw)
        for p in ps:
            p.grad = torch.ones_like(p)
        opt.step()
    with pytest.raises(NotImplementedError, match="ZeRO"):
        fo.fused_adamw_zero1()
