"""The port's kernel modules (safe_denoiser_tpu_torch/ops) against the JAX
package on the CPU.

Each kernel's plain PyTorch version -- what a CPU tensor takes -- is held
against the JAX package's Pallas kernel run in interpret mode (as the JAX
package's own kernel tests run it) on the same numpy-seeded inputs. The
CUDA kernels themselves run only on the GPU (chip_smoke.py). Tolerances are
f32 round-off unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.ops import attention as j_attn
from safe_denoiser_tpu.ops import conv3x3 as j_conv
from safe_denoiser_tpu.ops import group_norm as j_gn
from safe_denoiser_tpu.ops import repellency_kernels as j_rep
from safe_denoiser_tpu_torch import ops
from safe_denoiser_tpu_torch.ops import adaln as t_adaln
from safe_denoiser_tpu_torch.ops import attention as t_attn
from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv
from safe_denoiser_tpu_torch.ops import group_norm as t_gn
from safe_denoiser_tpu_torch.ops import repellency_kernels as t_rep


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("s", [512, 600])   # 600: padded tail, masked keys
def test_self_attention_matches_jax_kernel(s):
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(1, s, 2, 40).astype(np.float32) for _ in range(3))
    scale = 40 ** -0.5
    want = np.asarray(j_attn.self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        interpret=True))
    got = t_attn.self_attention(_t(q), _t(k), _t(v), scale).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_wide_head_chunked_attention_matches_jax():
    """The VAE mid-block form (one head, D=512, S % 512 == 0) takes the
    q-chunked plain path, like the JAX package's chunked einsum."""
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(1, 1024, 1, 512).astype(np.float32) * 0.2
               for _ in range(3))
    scale = 512 ** -0.5
    want = np.asarray(j_attn._chunked_einsum_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    got = t_attn.self_attention(_t(q), _t(k), _t(v), scale).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("args", [(512, 512, 40), (256, 256, 40),
                                  (512, 77, 40), (4096, 4096, 512),
                                  (4096, 4096, 300), (600, 600, 80)])
def test_attention_supports_matches_jax(args):
    assert t_attn.supports(*args) == j_attn.supports(*args)


# --------------------------------------------------------------------- rbf
@pytest.mark.parametrize("normalize", [True, False])
def test_rbf_score_matches_jax_kernel(normalize):
    rs = np.random.RandomState(2)
    refs = rs.randn(37, 1024).astype(np.float32)
    x = (refs[:3] + 0.3 * rs.randn(3, 1024)).astype(np.float32)
    sigma = 30.0
    wn, wb = j_rep.rbf_negative_score_pallas(
        jnp.asarray(x), jnp.asarray(refs), sigma, 1e-8, normalize=normalize,
        interpret=True)
    gn, gb = t_rep.rbf_negative_score(_t(x), _t(refs), sigma, 1e-8,
                                      normalize=normalize)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-5)


def test_sparse_force_and_pairwise_dist_match_jax():
    rs = np.random.RandomState(3)
    refs = rs.randn(20, 64).astype(np.float32)
    x = (refs[:4] + 0.5 * rs.randn(4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        t_rep._pairwise_dist(_t(x), _t(refs)).numpy(),
        np.asarray(j_rep._pairwise_dist(jnp.asarray(x), jnp.asarray(refs))),
        atol=1e-4, rtol=1e-5)
    radius = 6.0
    for raw in (False, True):
        want = j_rep.sparse_repellency_force(jnp.asarray(x),
                                             jnp.asarray(refs), radius,
                                             raw=raw)
        got = t_rep.sparse_repellency_force(_t(x), _t(refs), radius, raw=raw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)


# -------------------------------------------------------------- conv3x3_up
def _conv_case(shape, co, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(*shape).astype(np.float32)
    w_hwio = (rs.randn(3, 3, shape[-1], co) / np.sqrt(9 * shape[-1])
              ).astype(np.float32)
    b = (rs.randn(co) * 0.1).astype(np.float32)
    return h, w_hwio, b


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1)))


def test_conv3x3_up_matches_jax_kernel_f32():
    h, w, b = _conv_case((1, 16, 16, 128), 128, seed=4)
    want = np.asarray(j_conv.conv3x3_up(jnp.asarray(h), jnp.asarray(w),
                                        jnp.asarray(b), interpret=True))
    got = t_conv.conv3x3_up(_t(h), _oihw(w), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_conv3x3_up_matches_jax_kernel_bf16():
    """bf16 as on the main path: the JAX kernel pre-sums its weights in
    bf16 and rounds the output to bf16; the plain version convolves the
    same bf16 values in f32. Tolerance: a few bf16 ulps of outputs ~ 1."""
    h, w, b = _conv_case((1, 16, 16, 128), 128, seed=5)
    hb, wb, bb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (h, w, b))
    want = np.asarray(j_conv.conv3x3_up(hb, wb, bb, interpret=True),
                      np.float32)
    got = t_conv.conv3x3_up(
        torch.from_numpy(np.array(hb, np.float32)).to(torch.bfloat16),
        _oihw(np.array(wb, np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.array(bb, np.float32)).to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2,
                               rtol=2e-2)


def test_w_eff_up_matches_jax():
    _, w, _ = _conv_case((1, 4, 4, 8), 16, seed=6)
    want = np.asarray(j_conv._w_eff_up(jnp.asarray(w)))      # [16, Ci, Co]
    got = t_conv.w_eff_up(torch.from_numpy(w)).reshape(16, 8, 16).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_kernel_weight_layout_reproduces_conv():
    """Emulates csrc/conv3x3_up.cu's implicit GEMM in numpy from the
    wrapper's [4, Co, 4*Ci] weights (parity p = 2*py+px, K index
    (2*j+k)*Ci + ci, half-res offsets j-1+py / k-1+px, zeros outside) and
    holds it against the plain version, so the layout the CUDA kernel reads
    is checked here on the CPU."""
    h, w, b = _conv_case((2, 6, 5, 32), 64, seed=7)
    bsz, h2, w2, ci = h.shape
    wt, bias = t_conv.pack_weights(_oihw(w), _t(b))          # [4, Co, 4Ci]
    wt, bias = wt.float().numpy(), bias.numpy()
    hp = np.pad(h, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((bsz, 2 * h2, 2 * w2, 64), np.float32)
    for py in range(2):
        for px in range(2):
            cols = []
            for j in range(2):
                for k in range(2):
                    dy, dx = j - 1 + py, k - 1 + px
                    cols.append(hp[:, 1 + dy:1 + dy + h2, 1 + dx:1 + dx + w2])
            a = np.concatenate(cols, axis=-1)                # [B,H2,W2,4Ci]
            out[:, py::2, px::2] = a @ wt[2 * py + px].T + bias
    want = t_conv.conv3x3_up_ref(_t(h), _oihw(w), _t(b)).numpy()
    # the kernel's weights are bf16: tolerance of bf16 weight rounding
    np.testing.assert_allclose(out, want, atol=2e-2)


@pytest.mark.parametrize("shape,co", [
    ((8, 32, 32, 640), 640), ((4, 64, 64, 512), 512),
    ((4, 256, 256, 256), 256), ((8, 16, 16, 1280), 1280),
    ((8, 8, 8, 1280), 1280), ((1, 16, 16, 128), 128)])
def test_supports_up_matches_jax(shape, co):
    assert t_conv.supports_up(shape, shape[-1], co) == \
        j_conv.supports_up(shape, shape[-1], co)


# --------------------------------------------------------------- group norm
def test_gn_stats_matches_jax_kernel():
    rs = np.random.RandomState(8)
    x = (rs.randn(2, 1024, 256) + 0.3).astype(np.float32)
    w1, w2 = j_gn.gn_stats_pallas(jnp.asarray(x), interpret=True)
    g1, g2 = t_gn.gn_stats(_t(x))
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=1e-4)


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 8192, 256)])
def test_gn_affine_coefs_matches_jax(shape):
    """(1, 8192, 256) passes the statistics gate (S*C >= 2**21)."""
    rs = np.random.RandomState(9)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    wa, wb = j_gn.gn_affine_coefs(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), 32)
    ga, gb = t_gn.gn_affine_coefs(_t(x), _t(scale), _t(bias), 32)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_ref_matches_jax(dtype, act):
    """f32: the two-pass form, f32 round-off. bf16: the fast form (affine
    and SiLU at bf16); tolerance two bf16 ulps of values ~ 3."""
    rs = np.random.RandomState(10)
    x = (rs.randn(2, 256, 128) * 1.5 + 0.2).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(128)).astype(np.float32)
    bias = (0.1 * rs.randn(128)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_gn.group_norm_ref(jx, jnp.asarray(scale),
                                          jnp.asarray(bias), 32, act=act),
                      np.float32)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch,
                                                                 dtype))
    got = t_gn.group_norm_ref(tx, _t(scale), _t(bias), 32, act=act)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)


# ------------------------------------------------------- no CPU launches
def test_cpu_tensors_never_launch_a_kernel(monkeypatch):
    ops.reset_launch_counts()
    x = torch.randn(1, 512, 2, 40)
    t_attn.self_attention(x, x, x, 0.1)
    monkeypatch.setenv("SDT_INT8_ATTN", "1")     # the int8-QK^T form
    t_attn.self_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(), 0.1)
    for layout, repack in (("nt", "0"), ("nt", "1"), ("bshd", "0")):
        monkeypatch.setenv("SDT_FLASH2_LAYOUT", layout)
        monkeypatch.setenv("SDT_ATTN_REPACK", repack)
        t_attn.self_attention(x, x, x, 0.1)
    t_rep.rbf_negative_score(torch.randn(2, 128), torch.randn(5, 128), 3.0)
    t_conv.conv3x3_up(torch.randn(1, 16, 16, 128).bfloat16(),
                      torch.randn(128, 128, 3, 3).bfloat16())
    t_conv.conv3x3(torch.randn(1, 8, 16, 128).bfloat16(),
                   torch.randn(128, 128, 3, 3).bfloat16())
    t_conv.conv3x3_up(torch.randn(1, 16, 16, 128).bfloat16(),
                      torch.randn(128, 128, 3, 3).bfloat16(),
                      form="interleave")
    t_gn.gn_stats(torch.randn(1, 16384, 128))
    t_gn.group_norm_fused(torch.randn(1, 4096, 320).bfloat16(),
                          torch.randn(320), torch.randn(320), 32, act="silu")
    row = torch.randn(2, 64).bfloat16()
    t_adaln.adaln(torch.randn(2, 16, 64).bfloat16(), row, row, row,
                  torch.randn(2, 16, 64).bfloat16())
    assert ops.launch_counts() == {"attention": 0, "attention_i8": 0,
                                   "attention_nt": 0, "attention_bshd": 0,
                                   "repack_to_heads": 0,
                                   "repack_from_heads": 0, "rbf": 0,
                                   "conv3x3_up": 0,
                                   "conv3x3_up_interleave": 0, "conv3x3": 0,
                                   "gn_stats": 0, "gn_fused": 0,
                                   "adaln": 0}


@pytest.mark.parametrize("call", [
    lambda x: t_attn.self_attention(x((1, 512, 2, 40)), x((1, 512, 2, 40)),
                                    x((1, 512, 2, 40)), 0.1),
    lambda x: t_attn._self_attention_i8_cuda(
        x((1, 512, 2, 40)), x((1, 512, 2, 40)), x((1, 512, 2, 40)), 0.1),
    lambda x: t_attn.attention_nt(x((2, 512, 40)), x((2, 512, 40)),
                                  x((2, 512, 40)), 0.1, 500),
    lambda x: t_attn.attention_bshd(x((1, 512, 2, 40)), x((1, 512, 2, 40)),
                                    x((1, 512, 2, 40)), 0.1),
    lambda x: t_attn.repack_to_heads(x((1, 512, 80)), 2),
    lambda x: t_attn.repack_from_heads(x((1, 2, 512, 40))),
    lambda x: t_rep.rbf_negative_score(x((2, 128)), x((5, 128)), 3.0),
    lambda x: t_conv.conv3x3_up(x((1, 16, 16, 128)), x((128, 128, 3, 3))),
    lambda x: t_conv.conv3x3(x((1, 8, 16, 128)), x((128, 128, 3, 3))),
    lambda x: t_gn.gn_stats(x((1, 16384, 128))),
    lambda x: t_conv.conv3x3_up(x((1, 16, 16, 128)), x((128, 128, 3, 3)),
                                form="interleave"),
    lambda x: t_gn.group_norm_fused(x((1, 4096, 320)), x((320,)),
                                    x((320,)), 32)],
    ids=["attention", "attention_i8", "attention_nt", "attention_bshd",
         "repack_to_heads", "repack_from_heads", "rbf", "conv3x3_up",
         "conv3x3", "gn_stats", "conv3x3_up_interleave", "gn_fused"])
def test_non_cpu_tensors_never_take_the_plain_version(call):
    """No fallback: only a CPU tensor takes the plain version. A tensor on
    any other device goes to the kernel's wrapper, which raises here (no
    GPU) instead of computing."""
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="GPU"):
        call(lambda shape: torch.empty(shape, dtype=torch.bfloat16,
                                       device="meta"))
    assert set(ops.launch_counts().values()) == {0}
