"""The fused GroupNorm (+SiLU) kernel's plain version and dispatch, the
interleaved upsample conv's plain version and routing, and the fast-form
switches (SDT_FAST_SILU, SDT_FAST_GELU), against the JAX package on the
CPU. The JAX package's Pallas kernels run in interpret mode, as its own
tests run them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from safe_denoiser_tpu.models import layers as j_layers
from safe_denoiser_tpu.ops import conv3x3 as j_conv
from safe_denoiser_tpu.ops import group_norm as j_gn
from safe_denoiser_tpu_torch.models import SD14_UNET
from safe_denoiser_tpu_torch.models import layers as t_layers
from safe_denoiser_tpu_torch.models import unet as t_unet
from safe_denoiser_tpu_torch.models import vae as t_vae
from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv
from safe_denoiser_tpu_torch.ops import group_norm as t_gn
from tests.test_torch_port_models import _nchw, jax_unet, torch_unet


def _bf16_ulp(m: float) -> float:
    """One bf16 ulp at magnitude m (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX and a torch array."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


# ----------------------------------------------------- B6 plain vs the TPU
@pytest.mark.parametrize("s,c,groups,act", [
    (64, 320, 32, None), (512, 320, 32, "silu"), (128, 96, 8, None),
    (16, 40, 4, "silu")])
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16-slow"])
def test_group_norm_fused_ref_matches_the_tpu_kernel(monkeypatch, s, c,
                                                     groups, act, mode):
    """``group_norm_fused_ref`` against ``group_norm_pallas`` in interpret
    mode: the JAX package's own cases (tests/test_group_norm_kernel.py)
    plus a small one. f32 within 2e-5, the JAX test's bound. bf16 (x ~
    N(5, 2^2), where the one-pass variance cancels most) within one bf16
    ulp of max|y|, under SDT_FAST_SILU=1 (SiLU at bf16) and 0 (SiLU in
    f32); read: <= one ulp, e.g. 0.03125 at max|y| 10.5 with the fast
    SiLU and 4.9e-4 without it, at [2, 256, 64]."""
    monkeypatch.setenv("SDT_FAST_SILU", "0" if mode == "bf16-slow" else "1")
    j_gn.group_norm_pallas.clear_cache()      # the switch is read at trace
    rng = np.random.RandomState(0)
    x = rng.randn(2, s, c) * 2 + (0.5 if mode == "f32" else 5.0)
    scale = rng.randn(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    if mode == "f32":
        jx, tx = jnp.asarray(x, jnp.float32), torch.from_numpy(
            x.astype(np.float32))
    else:
        jx, tx = _bf16_pair(x.astype(np.float32))
    want = np.asarray(j_gn.group_norm_pallas(
        jx, jnp.asarray(scale), jnp.asarray(bias), groups, act=act,
        interpret=True), np.float32)
    got = t_gn.group_norm_fused_ref(tx, torch.from_numpy(scale),
                                    torch.from_numpy(bias), groups, act=act)
    assert got.dtype == tx.dtype
    err = np.abs(got.float().numpy() - want).max()
    tol = 2e-5 if mode == "f32" else _bf16_ulp(np.abs(want).max())
    assert err <= tol, (err, tol)


def test_group_norm_fused_wrapper_on_the_cpu_takes_the_plain_version():
    x = torch.randn(2, 64, 32)
    sc, b = torch.randn(32), torch.randn(32)
    t_gn.fused_launches = 0
    assert torch.equal(t_gn.group_norm_fused(x, sc, b, 8, act="silu"),
                       t_gn.group_norm_fused_ref(x, sc, b, 8, act="silu"))
    assert t_gn.fused_launches == 0


# ------------------------------------------------------- B6 dispatch gate
def test_fused_gate_on_the_sd14_unet(monkeypatch):
    """SDT_FUSED_GN=1: of the SD-v1.4 UNet's 61 GroupNorms a step at 64^2
    latents, 57 pass the JAX package's gate (S*C <= 4096*320, C % G == 0,
    S % min(512, S) == 0); the four that fall through are up_blocks[2]'s
    first norm1 (S 1024, C 1920) and up_blocks[3]'s three norm1s (S 4096,
    C 960, 640, 640), the last three large enough for the statistics
    kernel. Without the switch none pass."""
    shapes = chip_smoke.unet_norm_shapes(SD14_UNET, 64, 64)
    assert len(shapes) == 61
    monkeypatch.setenv("SDT_FUSED_GN", "1")
    fall = [(s, c) for s, c, g in shapes if not t_gn.takes_fused_kernel(s, c,
                                                                        g)]
    assert fall == [(1024, 1920), (4096, 960), (4096, 640), (4096, 640)]
    assert [t_gn.takes_stats_kernel(s, c) for s, c in fall] == \
        [False, True, True, True]
    for s, c, g, want in ((4096, 320, 32, True), (1024, 1280, 32, True),
                          (64, 2560, 32, True), (4096, 336, 32, False),
                          (4096, 96, 7, False), (600, 320, 32, False),
                          (300, 320, 32, True)):
        assert t_gn.takes_fused_kernel(s, c, g) is want, (s, c, g)
    monkeypatch.delenv("SDT_FUSED_GN")
    assert not any(t_gn.takes_fused_kernel(s, c, g) for s, c, g in shapes)


def test_unet_norm_shapes_follow_the_module(monkeypatch):
    """``chip_smoke.unet_norm_shapes`` (the launch plan) lists the (S, C)
    of every GroupNorm a tiny UNet's forward runs, in order."""
    _, params = jax_unet()
    tu = torch_unet(params)
    seen = []
    real = t_layers.group_norm

    def spy(x, scale, bias, groups, eps, act):
        seen.append((x.shape[1], x.shape[2], groups))
        return real(x, scale, bias, groups, eps, act)

    monkeypatch.setattr(t_layers, "group_norm", spy)
    with torch.no_grad():
        tu(torch.zeros(1, 4, 24, 24), 10, torch.zeros(1, 5, 32))
    assert seen == chip_smoke.unet_norm_shapes(tu.config, 24, 24)


def _jax_group_norm_interpret(x, scale, bias, groups, epsilon=1e-6,
                              act=None):
    """The JAX package's dispatch with its TPU condition dropped: the gate's
    shapes go to the fused kernel in interpret mode."""
    b, s, c = x.shape
    if (s * c <= j_gn._MAX_TILE_ELEMS and c % groups == 0
            and s % min(j_gn._S_TILE, s) == 0):
        return j_gn.group_norm_pallas(x, scale, bias, groups, epsilon, act,
                                      interpret=True)
    return j_gn.group_norm_ref(x, scale, bias, groups, epsilon, act)


def test_unet_under_fused_gn_matches_jax(monkeypatch):
    """A tiny UNet (f32, 24^2) under SDT_FUSED_GN=1 against the JAX UNet
    whose GroupNorms take the fused kernel in interpret mode where its gate
    admits them (the CPU backend would skip the kernel): the 144-token
    level's; the 576-token level's fall through (576 % 512 != 0) in both.
    Tolerance 1e-4, the UNet's."""
    model, params = jax_unet()
    monkeypatch.setattr(j_gn, "group_norm", _jax_group_norm_interpret)
    monkeypatch.setenv("SDT_FUSED_GN", "1")
    rs = np.random.RandomState(3)
    x = rs.randn(2, 24, 24, 4).astype(np.float32)
    ctx = rs.randn(2, 5, 32).astype(np.float32)
    want = jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(981),
                                jnp.asarray(ctx))
    calls = []
    real = t_gn.group_norm_fused
    monkeypatch.setattr(t_gn, "group_norm_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = torch_unet(params)(torch.from_numpy(_nchw(x).copy()), 981,
                                 torch.from_numpy(ctx))
    shapes = chip_smoke.unet_norm_shapes(torch_unet(params).config, 24, 24)
    admitted = sum(t_gn.takes_fused_kernel(*sh) for sh in shapes)
    assert len(calls) == admitted and 0 < admitted < len(shapes)
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------- B7 plain vs the TPU
def test_conv3x3_up_ref_matches_the_interleave_kernel():
    """``conv3x3_up_ref`` against ``conv3x3_up(form="interleave",
    interpret=True)`` at tests/test_conv3x3.py's edge-band shape, within
    that file's bound (atol 0.13, rtol 0.05, bulk and image frame), bf16;
    on the CPU the port's interleave wrapper is the plain version."""
    rng = np.random.RandomState(11)
    shape, co = (2, 16, 16, 128), 128
    x, tx = _bf16_pair(rng.randn(*shape).astype(np.float32))
    w, tw = _bf16_pair((rng.randn(3, 3, shape[-1], co) * 0.05).astype(
        np.float32))
    b, tb = _bf16_pair((rng.randn(co) * 0.1).astype(np.float32))
    want = np.asarray(j_conv.conv3x3_up(x, w, b, form="interleave",
                                        interpret=True), np.float32)
    w_oihw = tw.permute(3, 2, 0, 1).contiguous()
    got = t_conv.conv3x3_up(tx, w_oihw, tb, form="interleave")
    assert torch.equal(got, t_conv.conv3x3_up_ref(tx, w_oihw, tb))
    got = got.float().numpy()
    for sl in ((), (slice(None), 0), (slice(None), -1),
               (slice(None), slice(None), 0), (slice(None), slice(None), -1)):
        np.testing.assert_allclose(got[sl], want[sl], atol=0.13, rtol=0.05)
    with pytest.raises(ValueError, match="form"):
        t_conv.conv3x3_up(tx, w_oihw, tb, form="interleaved")


def test_up_form_switch_routes_the_vae_upsamples_only(monkeypatch):
    """SDT_UP_FORM=interleave sends the VAE decoder's upsamples to the
    interleave form and leaves the UNet's on the planar one (the JAX
    package hard-codes planar there); unset, both are planar."""
    forms = []
    real = t_conv.conv3x3_up

    def spy(*a, form="planar", **k):
        forms.append(form)
        return real(*a, form=form, **k)

    monkeypatch.setattr(t_conv, "conv3x3_up", spy)
    x = torch.randn(1, 128, 16, 16).bfloat16()
    vae_up = t_vae.Upsample2D(128).bfloat16()
    unet_up = t_unet.Upsample2D(128).bfloat16()
    with torch.no_grad():
        vae_up(x), unet_up(x)
        monkeypatch.setenv("SDT_UP_FORM", "interleave")
        vae_up(x), unet_up(x)
    assert forms == ["planar", "planar", "interleave", "planar"]


# ------------------------------------------------ the fast-form switches
@pytest.mark.parametrize("what", ["group_norm_silu", "layer_norm", "gelu"])
def test_fast_switches_match_jax_when_off(monkeypatch, what):
    """With SDT_FAST_SILU=0 (GroupNorm+SiLU, LayerNorm) or SDT_FAST_GELU=0
    the port's bf16 forms follow the JAX package's slow ones: within one
    bf16 ulp of max|y|. Before the switches were read the port kept the
    fast forms: 0.078 at max|y| 7.59 (GroupNorm+SiLU, [2, 256, 64], 8
    groups, x ~ N(5, 2^2)) and 0.0625 at max|y| 7.0 (LayerNorm)."""
    rng = np.random.RandomState(0)
    monkeypatch.setenv("SDT_FAST_SILU", "0")
    monkeypatch.setenv("SDT_FAST_GELU", "0")
    if what == "group_norm_silu":
        jx, tx = _bf16_pair((rng.randn(2, 256, 64) * 2 + 5).astype(
            np.float32))
        sc = (1 + 0.5 * rng.randn(64)).astype(np.float32)
        b = (0.5 * rng.randn(64)).astype(np.float32)
        want = j_gn.group_norm_ref(jx, jnp.asarray(sc), jnp.asarray(b), 8,
                                   act="silu")
        got = t_gn.group_norm_ref(tx, torch.from_numpy(sc),
                                  torch.from_numpy(b), 8, act="silu")
    elif what == "layer_norm":
        jx, tx = _bf16_pair((rng.randn(2, 77, 64) * 3 + 1).astype(
            np.float32))
        w = (1 + 0.5 * rng.randn(64)).astype(np.float32)
        b = (0.5 * rng.randn(64)).astype(np.float32)
        want = j_layers.LayerNormFp32().apply({"params": {"LayerNorm_0": {
            "scale": jnp.asarray(w), "bias": jnp.asarray(b)}}}, jx)
        ln = t_layers.LayerNormFp32(64)
        with torch.no_grad():
            ln.weight.copy_(torch.from_numpy(w))
            ln.bias.copy_(torch.from_numpy(b))
            got = ln(tx)
    else:
        jx, tx = _bf16_pair((rng.randn(4096) * 3).astype(np.float32))
        want = j_layers._gelu_for(jnp.bfloat16)(jx)
        got = t_layers.gelu_for(torch.bfloat16)(tx)
        assert torch.equal(got, torch.nn.functional.gelu(tx))   # exact erf
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _bf16_ulp(np.abs(want).max()), err
