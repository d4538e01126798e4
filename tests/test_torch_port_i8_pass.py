"""B8's once-per-call quantize pass and the attention core's int8 form,
as their plain versions compose them, against the JAX package on the CPU.

The pass (``csrc/attention_i8.cu``) quantizes Q per query row and K per key
token into head-major int8 rows padded to a multiple of 64 with f32 dequant
factors beside them; the core's int8 form (``attn_i8_kernel`` in
``csrc/attention_hopper.cuh``) takes the integer logits, dequantizes them
as (float(s32) * q_deq) * k_deq and runs the exp2 softmax. Its plain
version, ``attention_i8_from_quantized``, composes the same steps; with K
quantized once for all query blocks it must still match the TPU kernel,
which quantizes K again in every query block. The kernel's s32 -> f32
conversion by an integer add is checked in numpy over every logit a head
dim up to 256 can give.
"""

import numpy as np
import pytest
import torch

from safe_denoiser_tpu_torch.ops import attention as t_attn
from tests.test_torch_port_quant import _jax_i8


def _case(s, d, zero_rows, seed):
    """[1, S, 2, D] f32 q, k, v; with ``zero_rows`` an all-zero query row
    and two all-zero key tokens (the last one among them), which take the
    1e-20 guard."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(1, s, 2, d).astype(np.float32) for _ in range(3))
    if zero_rows:
        q[0, 3] = 0.0
        k[0, 5] = 0.0
        k[0, s - 1] = 0.0
    return q, k, v


@pytest.mark.parametrize("d", [40, 64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_pass_equals_quantize_rows_i8(d, dtype):
    """int8 values and dequant factors bit for bit those of
    ``quantize_rows_i8`` (the TPU kernel's ``_i8``) with JAX's f32
    constants, head-major, and the pad columns up to the 64-multiple
    zero."""
    q, k, _ = _case(37, d, True, seed=d)
    tq, tk = (torch.from_numpy(t).to(dtype) for t in (q, k))
    scale = d ** -0.5
    qi, ki, qd, kd = t_attn.quantize_i8_ref(tq, tk, scale)
    nv = t_attn.i8_width(d)
    assert nv == -(-d // 64) * 64 and nv % 64 == 0
    cq = torch.tensor(scale * t_attn.LOG2E / 127.0, dtype=torch.float32)
    ck = torch.tensor(1.0 / 127.0, dtype=torch.float32)
    for xi, deq, x, c in ((qi, qd, tq, cq), (ki, kd, tk, ck)):
        want, amax = t_attn.quantize_rows_i8(x)        # [1, S, 2, D]
        want = want.permute(0, 2, 1, 3).reshape(2, 37, d)
        amax = amax.permute(0, 2, 1, 3).reshape(2, 37)
        assert xi.dtype == torch.int8 and xi.shape == (2, 37, nv)
        assert torch.equal(xi[..., :d].float(), want)
        assert not xi[..., d:].any()
        assert deq.dtype == torch.float32
        assert torch.equal(deq, amax * c)
    assert not qi[0, 3].any() and qd[0, 3] == 0     # the zero rows
    assert not ki[:, 5].any() and not kd[:, 5].any()


@pytest.mark.parametrize("d", [40, 64, 80])
def test_attention_from_once_quantized_k_matches_the_tpu_kernel(d):
    """f32 inputs: the plain composition of the pass and the int8 form
    against the TPU kernel (quant_i8, interpret mode) at S = 600 (padded
    to 1024 there, 424 keys masked) with zero rows, within the f32
    tolerance of ``test_torch_port_quant.py`` (2e-5)."""
    q, k, v = _case(600, d, True, seed=600 + d)
    scale = d ** -0.5
    want = _jax_i8(q, k, v, scale)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = t_attn.attention_i8_from_quantized(
        *t_attn.quantize_i8_ref(tq, tk, scale), tv)
    assert got.shape == tv.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("d", [40, 80])
def test_attention_from_once_quantized_k_matches_the_tpu_kernel_in_bf16(d):
    """bf16 inputs: both round P to bf16 for P V (the TPU kernel before
    normalizing, as the int8 form does), within the bf16 attention bound
    (BF16_ATOL)."""
    import jax.numpy as jnp

    q, k, v = _case(600, d, True, seed=700 + d)
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    want = _jax_i8(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                     for t in (tq, tk, tv)), d ** -0.5)
    got = t_attn.attention_i8_from_quantized(
        *t_attn.quantize_i8_ref(tq, tk, d ** -0.5), tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=t_attn.BF16_ATOL, rtol=0)


def _s32_to_f32(s32):
    """The int8 form's conversion (``s32_to_f32``): add 0x4B400000 (the
    bits of 1.5 * 2^23) to the integer's bits, read them as a float, and
    subtract 1.5 * 2^23 in f32."""
    bits = s32.astype(np.int64) + 0x4B400000
    return (bits.astype(np.uint32).view(np.float32)
            - np.float32(12582912.0)).astype(np.float32)


def test_s32_conversion_is_exact_for_every_padded_head_dim():
    """Exact for every logit |s32| <= 127^2 * 256 (a head dim padded to
    256), and no longer past 2^22."""
    top = 127 * 127 * 256
    assert top < 2 ** 22
    s32 = np.arange(-top, top + 1, dtype=np.int32)
    assert np.array_equal(_s32_to_f32(s32), s32.astype(np.float32))
    past = np.array([2 ** 22 + 1, -2 ** 22 - 1, 2 ** 23 - 3], np.int32)
    assert not np.any(_s32_to_f32(past) == past.astype(np.float32))
