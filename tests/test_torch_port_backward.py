"""The port's backward kernels' plain versions and autograd Functions, on
the CPU: B1 (``ops/attention.py::SelfAttention``), B5
(``ops/group_norm.py::GNStats``) and B3 (``ops/conv3x3.py::ConvUp``).

- each Function passes ``torch.autograd.gradcheck`` in f64 at tiny shapes,
  and its forward equals the no-grad path's bit for bit;
- each backward's plain version (written from its formula) against
  ``jax.vjp`` of the JAX package's XLA path: the einsum attention of
  ``models/layers.py::dot_product_attention``, the f32 sums of
  ``ops/group_norm.py::gn_affine_coefs``, the UNet upsample's resize +
  conv (``models/unet.py::UpsampleT``), in f32 and bf16;
- numpy walks of B3b's two kernels (``csrc/conv3x3_up_bwd.cu``): dh as a
  4x4 stride-2 conv over dy with the folded weights, dW through the 16
  parity partials folded into the 9 taps, against the autograd of
  ``conv3x3_up_ref``; a walk that drops one partial fails (the kernels'
  own tilings: ``test_torch_port_b3b_walk.py``); the folded weights,
  made on the weight's device, keep the bits of the host table's fold;
- every CUDA wrapper of a kernel without a backward raises under autograd
  (``ops/_grad.py::check_no_grad``), before anything else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.models import layers as j_layers
from safe_denoiser_tpu.ops import group_norm as j_gn
from safe_denoiser_tpu_torch.ops import _grad
from safe_denoiser_tpu_torch.ops import attention as t_attn
from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv
from safe_denoiser_tpu_torch.ops import group_norm as t_gn
from safe_denoiser_tpu_torch.ops import repellency_kernels as t_rep
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

# bf16 bounds against JAX's bf16 vjp, max |d| / max |jax|: the two round
# q * scale, the probabilities and the products' inputs to bf16 at other
# places (JAX scales q in bf16 before its f32 logits; the port in f32)
BF16_RTOL = 3e-2
F32_RTOL = 2e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


# ------------------------------------------------------------ gradcheck
def test_self_attention_function_gradcheck():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 24, 2, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: t_attn.SelfAttention.apply(q, k, v, 0.3), (q, k, v))


def test_gn_stats_function_gradcheck():
    x = torch.randn(2, 6, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(t_gn.GNStats.apply, (x,))


@pytest.mark.parametrize("bias", [True, False])
def test_conv_up_function_gradcheck(bias):
    g = torch.Generator().manual_seed(1)
    h = torch.randn(1, 3, 4, 2, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(3, 2, 3, 3, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = (torch.randn(3, generator=g, dtype=torch.float64, requires_grad=True)
         if bias else None)
    args = (h, w) + ((b,) if bias else ())
    assert torch.autograd.gradcheck(
        lambda *a: t_conv.ConvUp.apply(a[0], a[1], a[2] if bias else None,
                                       None), args)


def test_functions_forward_equals_the_no_grad_path():
    """Under autograd each public entry goes through its Function, whose
    forward is the no-grad path's, bit for bit (bf16 and f32)."""
    g = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(1, 512, 2, 40, generator=g).to(dtype)
                   for _ in range(3))
        want = t_attn.self_attention(q, k, v, 0.15)
        got = t_attn.self_attention(q.requires_grad_(), k, v, 0.15)
        assert got.grad_fn is not None and torch.equal(got.detach(), want)
        x = torch.randn(1, 64, 128, generator=g).to(dtype)
        want = t_gn.gn_stats(x)
        got = t_gn.gn_stats(x.requires_grad_())
        assert all(a.grad_fn is not None and torch.equal(a.detach(), b)
                   for a, b in zip(got, want))
        h = torch.randn(1, 16, 16, 128, generator=g).to(dtype)
        w = (torch.randn(128, 128, 3, 3, generator=g) / 30).to(dtype)
        want = t_conv.conv3x3_up(h, w)
        got = t_conv.conv3x3_up(h, w.requires_grad_())
        assert got.grad_fn is not None and torch.equal(got.detach(), want)


# -------------------------------------------------- against jax.vjp (XLA)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [512, 600])
def test_attention_backward_matches_jax_vjp(dtype, s):
    """The einsum path's vjp (what JAX's trainer differentiates on the CPU)
    against ``attention_bwd_ref`` on B1's forward output; S = 600 has a
    tail past the 512 grid."""
    rs = np.random.RandomState(s)
    q, k, v, do = (rs.randn(1, s, 2, 40).astype(np.float32) * 0.7
                   for _ in range(4))
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    out_j, vjp = jax.vjp(j_layers.dot_product_attention,
                         *(_j(a, jd) for a in (q, k, v)))
    want = vjp(_j(do, jd))
    tq, tk, tv, tdo = (_t(a, td) for a in (q, k, v, do))
    out = t_attn.attention_ref(tq, tk, tv, 40 ** -0.5)
    got = t_attn.attention_bwd_ref(tq, tk, tv, out, tdo, 40 ** -0.5)
    tol = F32_RTOL if dtype == "f32" else BF16_RTOL
    for g_, w_ in zip(got, want):
        assert g_.dtype == td
        assert _rel(g_.float(), np.asarray(w_, np.float32)) <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gn_stats_backward_matches_jax_vjp(dtype):
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 64, 128) * 2 + 1).astype(np.float32)
    ds1, ds2 = rs.randn(2, 128).astype(np.float32), \
        rs.randn(2, 128).astype(np.float32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16

    def sums(x):      # ops/group_norm.py::gn_affine_coefs' XLA branch
        xf = x.astype(jnp.float32)
        return jnp.sum(xf, axis=1), jnp.sum(xf * xf, axis=1)

    _, vjp = jax.vjp(sums, _j(x, jd))
    (want,) = vjp((jnp.asarray(ds1), jnp.asarray(ds2)))
    got = t_gn.gn_stats_bwd_ref(_t(x, td), _t(ds1), _t(ds2))
    assert got.dtype == td
    # f32: exact formula; bf16: both round the same f32 value once
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-6 if dtype == "f32" else 0,
                               atol=1e-5 if dtype == "f32" else 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gn_affine_coefs_gradient_matches_jax(monkeypatch, dtype):
    """The port's ``gn_affine_coefs`` takes the statistics Function here
    (the gate lowered), JAX's its XLA sums: the gradients of a loss of
    (a_c, b_c) with respect to x, scale and bias agree."""
    monkeypatch.setenv("SDT_GN_STATS_MIN", "10")
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 64, 128) * 2 + 1).astype(np.float32)
    sc, bi = 1 + 0.1 * rs.randn(128), 0.3 * rs.randn(128)
    wa, wb = rs.randn(2, 128), rs.randn(2, 128)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16

    def j_loss(x, sc, bi):
        a, b = j_gn.gn_affine_coefs(x, sc, bi, 32)
        return jnp.sum(a * wa) + jnp.sum(b * wb)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        _j(x, jd), jnp.asarray(sc, jnp.float32), jnp.asarray(bi, jnp.float32))
    tx = _t(x, td).requires_grad_()
    tsc, tbi = _t(sc).requires_grad_(), _t(bi).requires_grad_()
    a, b = t_gn.gn_affine_coefs(tx, tsc, tbi, 32)
    assert a.grad_fn is not None
    (torch.sum(a * _t(wa)) + torch.sum(b * _t(wb))).backward()
    tol = F32_RTOL * 10 if dtype == "f32" else BF16_RTOL
    for g_, w_ in zip((tx.grad, tsc.grad, tbi.grad), want):
        assert _rel(g_.float(), np.asarray(w_, np.float32)) <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_up_backward_matches_jax_vjp(dtype):
    """The UNet upsample's XLA form in JAX (``models/unet.py::UpsampleT``
    off the TPU: a nearest resize, then flax's conv in the module's dtype)
    differentiated by ``jax.vjp`` against ``conv3x3_up_bwd_ref``. (The
    conv3x3_up fallback's ``preferred_element_type=f32`` conv has no bf16
    transpose in JAX.)"""
    rs = np.random.RandomState(5)
    h = rs.randn(2, 6, 8, 16).astype(np.float32)
    w = (rs.randn(3, 3, 16, 24) / 12).astype(np.float32)      # HWIO
    b = rs.randn(24).astype(np.float32)
    dy = rs.randn(2, 12, 16, 24).astype(np.float32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16

    def up_conv(h, w, b):
        bsz, h2, w2, ci = h.shape
        up = jax.image.resize(h, (bsz, 2 * h2, 2 * w2, ci), "nearest")
        return jax.lax.conv_general_dilated(
            up, w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    _, vjp = jax.vjp(up_conv, _j(h, jd), _j(w, jd), _j(b, jd))
    dh_j, dw_j, db_j = vjp(_j(dy, jd))
    dh, dw, db = t_conv.conv3x3_up_bwd_ref(
        _t(h, td), _t(w.transpose(3, 2, 0, 1), td), _t(dy, td))
    tol = F32_RTOL if dtype == "f32" else BF16_RTOL
    assert _rel(dh.float(), dh_j) <= tol
    assert _rel(dw.float(), np.asarray(dw_j, np.float32).transpose(
        3, 2, 0, 1)) <= tol
    assert _rel(db.float(), db_j) <= tol


# ------------------------------------------------ B3b's walks in numpy
def _autograd_conv_up(h, w, dy):
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.zeros(w.shape[0], dtype=torch.float64, requires_grad=True)
    y = t_conv.conv3x3_up_ref(th, tw, tb)
    y.backward(torch.from_numpy(dy))
    return th.grad.numpy(), tw.grad.numpy(), tb.grad.numpy()


def _walk_dx(dy, w):
    """B3b-dx: dh[b,i,j] = sum over the 16 taps (u, v in -1..2) of
    dy[b, 2i+u, 2j+v] @ W4[u,v] (zero outside dy), W4 folded as
    ``bwd_dx_weights`` folds it (here in f64)."""
    fold = np.asarray(t_conv._FOLD, np.float64)
    w4 = np.einsum("uy,vx,oiyx->uvio", fold, fold, w)       # [4,4,Ci,Co]
    bsz, hh, ww, co = dy.shape
    h2, w2 = hh // 2, ww // 2
    pad = np.zeros((bsz, hh + 3, ww + 3, co))
    pad[:, 1:hh + 1, 1:ww + 1] = dy
    dh = np.zeros((bsz, h2, w2, w.shape[1]))
    for u in range(4):
        for v in range(4):
            taps = pad[:, u:u + 2 * h2:2, v:v + 2 * w2:2]   # dy[2i+u-1, .]
            dh += np.einsum("bxyo,co->bxyc", taps, w4[u, v])
    return dh


def _walk_dw(dy, h, drop=None):
    """B3b-dw: pass 1's 16 partials dWeff[py,px,j,k] = sum over the
    half-resolution positions of dy[2i+py, 2jj+px] x h[i+py+j-1,
    jj+px+k-1]; pass 2 adds for tap (ky, kx) the four whose groups hold it
    (``csrc/conv3x3_up_bwd.cu::group_of``) in the kernel's order. ``drop``:
    a (py, px, j, k) partial left out (a mutant)."""
    bsz, h2, w2, ci = h.shape
    co = dy.shape[3]
    hp = np.zeros((bsz, h2 + 2, w2 + 2, ci))
    hp[:, 1:h2 + 1, 1:w2 + 1] = h
    part = {}
    for py in range(2):
        for px in range(2):
            g = dy[:, py::2, px::2]                          # [B,h2,w2,Co]
            for j in range(2):
                for k in range(2):
                    sh = hp[:, py + j:py + j + h2, px + k:px + k + w2]
                    part[py, px, j, k] = np.einsum("bijo,bijc->oc", g, sh)

    def group_of(p, t):
        return (0 if t == 0 else 1) if p == 0 else (1 if t == 2 else 0)

    dw = np.zeros((co, ci, 3, 3))
    for ky in range(3):
        for kx in range(3):
            for py in range(2):
                for px in range(2):
                    key = (py, px, group_of(py, ky), group_of(px, kx))
                    if key != drop:
                        dw[:, :, ky, kx] += part[key]
    return dw


def test_b3_backward_walks_match_autograd():
    rs = np.random.RandomState(6)
    h = rs.randn(2, 5, 6, 8)
    w = rs.randn(12, 8, 3, 3)
    dy = rs.randn(2, 10, 12, 12)
    dh, dw, db = _autograd_conv_up(h, w, dy)
    np.testing.assert_allclose(_walk_dx(dy, w), dh, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_walk_dw(dy, h), dw, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dy.sum((0, 1, 2)), db, rtol=1e-12)
    # the folded weights are the kernel's, up to their bf16 rounding
    w4 = t_conv.bwd_dx_weights(torch.from_numpy(w))
    fold = np.asarray(t_conv._FOLD, np.float64)
    want = np.einsum("uy,vx,oiyx->uvio", fold, fold, w).reshape(16, 8, 12)
    np.testing.assert_allclose(w4.float().numpy(), want, rtol=8e-3,
                               atol=1e-6)
    for drop in ((0, 0, 0, 0), (1, 1, 1, 0)):
        assert np.abs(_walk_dw(dy, h, drop) - dw).max() > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_dx_weights_slice_sums_keep_the_einsums_bits(dtype):
    """``bwd_dx_weights`` sums weight slices on the weight's device (no
    fold table copied from the host, no wait for the stream) and gives,
    bit for bit, the einsum over the host table ``_FOLD`` that it
    replaces."""
    rs = np.random.RandomState(9)
    w = torch.from_numpy(rs.randn(48, 32, 3, 3).astype(np.float32)).to(dtype)
    fold = torch.tensor(t_conv._FOLD, dtype=torch.float32)
    want = torch.einsum("uy,vx,oiyx->uvio", fold, fold, w.float())
    want = want.reshape(16, 32, 48).to(torch.bfloat16).contiguous()
    got = t_conv.bwd_dx_weights(w)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ---------------------------------------------- no backward: raise first
def _meta(grad: bool):
    def make(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta",
                           requires_grad=grad)
    return make


NO_BACKWARD = {
    "attention (B1) in f32": lambda x: t_attn._self_attention_cuda(
        x((1, 512, 2, 40), torch.float32), x((1, 512, 2, 40), torch.float32),
        x((1, 512, 2, 40), torch.float32), 0.1),
    "attention_i8 (B8)": lambda x: t_attn._self_attention_i8_cuda(
        x((1, 512, 2, 40)), x((1, 512, 2, 40)), x((1, 512, 2, 40)), 0.1),
    "attention_nt (B9)": lambda x: t_attn._attention_nt_cuda(
        x((2, 512, 40)), x((2, 512, 40)), x((2, 512, 40)), 0.1, None),
    "attention_bshd (B10)": lambda x: t_attn._attention_bshd_cuda(
        x((1, 512, 2, 40)), x((1, 512, 2, 40)), x((1, 512, 2, 40)), 0.1),
    "repack_to_heads (B11)": lambda x: t_attn.repack_to_heads(
        x((1, 512, 80)), 2),
    "repack_from_heads (B12)": lambda x: t_attn.repack_from_heads(
        x((1, 2, 512, 40))),
    "rbf (B2)": lambda x: t_rep._rbf_cuda(
        x((2, 128), torch.float32), x((5, 128), torch.float32), 3.0, 1e-8,
        True),
    "conv3x3 (B4)": lambda x: t_conv._conv3x3_cuda(
        x((1, 8, 16, 128)), x((128, 128, 3, 3)), None, None, None, None,
        None, None),
    "conv3x3_up (B7": lambda x: t_conv._conv3x3_up_cuda(
        x((1, 16, 16, 128)), x((128, 128, 3, 3)), None, None, "interleave"),
    "group_norm_fused (B6)": lambda x: t_gn._group_norm_fused_cuda(
        x((1, 4096, 320)), x((320,), torch.float32),
        x((320,), torch.float32), 32, 1e-6, "silu"),
}


@pytest.mark.parametrize("name", list(NO_BACKWARD))
def test_no_backward_wrappers_raise_under_autograd(name):
    """The predicate is held on each such wrapper's inputs before any other
    check: with inputs that require grad it raises ``RuntimeError`` naming
    the kernel; without, or under ``no_grad``, the wrapper goes on to its
    device check (a ValueError here, on the CPU)."""
    call = NO_BACKWARD[name]
    with pytest.raises(RuntimeError, match="no backward yet") as err:
        call(_meta(True))
    assert name in str(err.value)
    with torch.no_grad(), pytest.raises(ValueError, match="GPU"):
        call(_meta(True))
    with pytest.raises(ValueError, match="GPU"):
        call(_meta(False))


def test_check_no_grad_predicate():
    x = torch.zeros(2, requires_grad=True)
    _grad.check_no_grad("k", torch.zeros(2), None)
    with torch.no_grad():
        _grad.check_no_grad("k", x)
    with pytest.raises(RuntimeError, match="k has no backward yet"):
        _grad.check_no_grad("k", torch.zeros(2), x)


def test_kernels_with_a_backward_route_through_their_functions():
    """On a non-CPU tensor under autograd, bf16 attention, the statistics
    and the planar up-conv enter their Functions (whose forwards reach the
    kernels' wrappers, refusing the meta device here); f32 attention has
    no backward and raises."""
    def meta(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta",
                           requires_grad=True)

    for call in (lambda: t_attn.self_attention(
                     meta((1, 512, 2, 40)), meta((1, 512, 2, 40)),
                     meta((1, 512, 2, 40)), 0.1),
                 lambda: t_gn.gn_stats(meta((1, 4096, 640))),
                 lambda: t_conv.conv3x3_up(meta((1, 16, 16, 128)),
                                           meta((128, 128, 3, 3)))):
        with pytest.raises(ValueError, match="GPU"):
            call()
    with pytest.raises(RuntimeError, match="no backward yet"):
        t_attn.self_attention(*(meta((1, 512, 2, 40), torch.float32)
                                for _ in range(3)), 0.1)
