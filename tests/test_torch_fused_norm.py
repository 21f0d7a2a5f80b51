"""The port's `rms_norm_rows` against the reference's Pallas kernel
(interpret mode off the TPU) on the CPU, where the port runs its plain
version: ± residual, bf16 and fp32. fp32 within atol/rtol 1e-5 (the two
sum in different orders); bf16 within one bf16 ulp (rounding of values
that differ in their last fp32 bits). The CUDA kernel runs only on the
card: tests/test_torch_cuda.py holds it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_norm as ref_fn
from paddle_tpu_torch.kernels import fused_norm as fn
from paddle_tpu_torch.nn.functional import rms_norm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_rows_matches_reference_kernel(dtype, residual):
    rng = np.random.RandomState(int(residual))
    R, H = 24, 256
    x, res = (rng.randn(R, H).astype(np.float32) * 2 for _ in range(2))
    w = rng.randn(H).astype(np.float32)
    tdt = getattr(torch, dtype)
    tx, tr = (torch.from_numpy(a).to(tdt) for a in (x, res))
    jx, jr = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (tx, tr))
    want = ref_fn.rms_norm_rows(jx, jnp.asarray(w), jr if residual else None,
                                eps=1e-6)
    got = fn.rms_norm_rows(tx, torch.from_numpy(w), tr if residual else None,
                           eps=1e-6)
    assert got.dtype == tdt and got.shape == (R, H)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


def test_op_order_differs_from_the_functional_rms_norm():
    """The rows kernel multiplies by the weight in fp32 before the cast;
    `nn.functional.rms_norm` casts first. In bf16 the two differ."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(8, 128).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(128).astype(np.float32)).bfloat16()
    rows = fn.rms_norm_rows(x, w)
    np.testing.assert_array_equal(rows.float().numpy(),
                                  fn.rms_norm_rows_ref(x, w).float().numpy())
    assert not torch.equal(rows, rms_norm(x, w))


def test_cpu_rules_and_no_backward():
    """On the CPU the reference's `check_supported_rms` holds (H % 128,
    bf16/fp32), with its verdicts; a gradient-requiring input raises."""
    for shape, dtype in (((4, 100), torch.float32),
                         ((4, 128), torch.float16),
                         ((4, 256), torch.bfloat16)):
        def verdict(check, dt):
            try:
                check(shape, dt)
            except ValueError:
                return False
            return True
        jdt = str(dtype).replace("torch.", "")
        assert verdict(fn.check_supported_rms, dtype) == \
            verdict(ref_fn.check_supported_rms, jdt)
    with pytest.raises(ValueError, match="H % 128"):
        fn.rms_norm_rows(torch.zeros(4, 100), torch.ones(100))
    x = torch.randn(4, 128, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn.rms_norm_rows(x, torch.ones(128))
    with torch.no_grad():
        assert fn.rms_norm_rows(x, torch.ones(128)).shape == (4, 128)
