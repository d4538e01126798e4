"""The fused VAE conv (B4) and what the bank build around it needs, against
the JAX package on the CPU: the conv's plain version against the Pallas
kernel in interpret mode, its shape gate, a VAE resnet in the fused form,
the beta calibration, and the ``.pt`` bank caches.

The CUDA kernel itself runs only on the GPU (tests/test_torch_port_cuda.py,
chip_smoke.py). Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu import io as j_io
from safe_denoiser_tpu.models import vae as j_vae
from safe_denoiser_tpu.ops import conv3x3 as j_conv
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu_torch import ops
from safe_denoiser_tpu_torch.models import vae as t_vae
from safe_denoiser_tpu_torch.models.weights_export import _inv_resnet
from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv
from safe_denoiser_tpu_torch.repellency import methods as t_methods
from tests.test_torch_port_models import random_params


def _bf16(a):
    """numpy f32 -> (the bf16-rounded jnp array, the same values as a torch
    bf16 tensor)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _case(shape, co, seed):
    rs = np.random.RandomState(seed)
    b, h, w, ci = shape
    x = rs.randn(*shape).astype(np.float32)
    wt = (rs.randn(3, 3, ci, co) / np.sqrt(9 * ci)).astype(np.float32)
    bias = (rs.randn(co) * 0.1).astype(np.float32)
    a = (1.0 + 0.2 * rs.randn(b, ci)).astype(np.float32)
    s = (0.5 * rs.randn(b, ci)).astype(np.float32)
    res = rs.randn(b, h, w, co).astype(np.float32)
    return x, wt, bias, a, s, res


MIXES = {"plain": (False, None, False), "pre_silu": (True, "silu", False),
         "pre_silu_residual": (True, "silu", True)}


# [2,16,16,128]: two row bands in the JAX kernel, so its top/bottom clamp
# runs; [1,32,16,256] -> 128: Ci != Co
@pytest.mark.parametrize("shape,co", [((2, 16, 16, 128), 128),
                                      ((1, 32, 16, 256), 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mix", list(MIXES))
def test_conv3x3_plain_matches_jax_kernel(shape, co, dtype, mix):
    """f32: f32 round-off (1e-4). bf16: the JAX kernel computes the SiLU as
    x/(1+exp(-x)) and the plain version as x*sigmoid(x), an ulp apart, and
    both round the output to bf16; tolerance as the up-conv's bf16 test."""
    x, wt, bias, a, s, res = _case(shape, co, seed=list(MIXES).index(mix))
    pre, act, with_res = MIXES[mix]
    assert j_conv.supports(shape, shape[-1], co)
    if dtype == "bf16":
        (jx, tx), (jw, tw), (jr, tr) = _bf16(x), _bf16(wt), _bf16(res)
    else:
        jx, jw, jr = jnp.asarray(x), jnp.asarray(wt), jnp.asarray(res)
        tx, tw, tr = (torch.from_numpy(v) for v in (x, wt, res))
    want = np.asarray(j_conv.conv3x3(
        jx, jw, jnp.asarray(bias), jnp.asarray(a) if pre else None,
        jnp.asarray(s) if pre else None, act, jr if with_res else None,
        interpret=True), np.float32)
    got = t_conv.conv3x3(
        tx, tw.permute(3, 2, 0, 1).contiguous(), torch.from_numpy(bias),
        torch.from_numpy(a) if pre else None,
        torch.from_numpy(s) if pre else None, act,
        tr if with_res else None)
    assert got.dtype == tx.dtype and got.shape == (*shape[:3], co)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "f32" else \
        dict(atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("b,h,w,ci,co", [
    (4, 64, 64, 512, 512), (4, 512, 512, 128, 128), (16, 256, 256, 128, 256),
    (1, 16, 16, 128, 128), (1, 8, 16, 128, 128), (1, 6, 16, 128, 128),
    (1, 5, 16, 128, 128), (1, 3, 16, 128, 128), (1, 64, 24, 128, 128),
    (1, 64, 64, 96, 128), (1, 64, 64, 128, 64), (1, 64, 64, 2048, 128),
    (2, 34, 48, 256, 256), (1, 1024, 1024, 128, 128)])
def test_conv3x3_supports_matches_jax(b, h, w, ci, co):
    assert t_conv.supports((b, h, w, ci), ci, co) == \
        j_conv.supports((b, h, w, ci), ci, co)


@pytest.mark.parametrize("ci,co", [(128, 128), (128, 256)])
def test_vae_resnet_fused_matches_jax(monkeypatch, ci, co):
    """One VAE resnet block in bf16, both packages in the fused form (GN
    coefficients, affine+SiLU prologue, residual epilogue): the JAX block
    under SDT_PALLAS_CONV=interpret, the port's through conv3x3's plain
    version. Tolerance: rms of the difference <= 1% of the output's rms
    (bf16 roundings in another order through two convs)."""
    monkeypatch.setenv("SDT_PALLAS_CONV", "interpret")
    model = j_vae.ResnetBlock(co, 32, dtype=jnp.bfloat16)
    x = np.random.RandomState(ci + co).randn(1, 16, 16, ci).astype(
        np.float32)
    params = random_params(model, 5, jax.random.PRNGKey(0),
                           jnp.zeros((1, 16, 16, ci), jnp.bfloat16))
    jx, tx = _bf16(x)
    want = np.asarray(model.apply(params, jx), np.float32)

    sd = {}
    _inv_resnet(params["params"], "blk", sd)
    blk = t_vae.ResnetBlock2D(ci, co, 32)
    blk.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    blk = blk.to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = blk(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
    assert set(ops.launch_counts().values()) == {0}
    d = got.numpy() - want
    rel = np.sqrt((d ** 2).mean() / (want ** 2).mean())
    assert rel <= 1e-2, rel


def test_gn_coefs_only_matches_jax():
    from safe_denoiser_tpu.models.layers import GroupNorm32 as JGN
    from safe_denoiser_tpu_torch.models.layers import GroupNorm32
    x = np.random.RandomState(3).randn(2, 8, 8, 64).astype(np.float32)
    jgn = JGN(8)
    params = random_params(jgn, 4, jax.random.PRNGKey(0), jnp.asarray(x))
    want = jgn.apply(params, jnp.asarray(x), coefs_only=True)
    gn = GroupNorm32(64, 8)
    p = params["params"]["GroupNorm_0"]
    gn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        got = gn(torch.from_numpy(x).permute(0, 3, 1, 2), coefs_only=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------------------- calibration
def test_empirical_beta_matches_jax():
    """The same injected noisy-bank dict through both packages' beta (and
    radius) calibration: the per-timestep quantiles agree to 1e-5
    relative."""
    rs = np.random.RandomState(11)
    refs = rs.randn(7, 4, 8, 8).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    noisy = {t: (refs * 0.8 + 0.6 * rs.randn(*refs.shape)).astype(np.float32)
             for t in (981, 501, 21)}
    kw = dict(embed_fn=None, sigma=4.0, beta_threshold=1.0, quantile=0.3)
    j = j_methods.KernelFastRepellency(ref_data=refs, cache_proj_ref=False,
                                       **{**kw, "embed_fn": lambda x: x})
    t = t_methods.KernelFastRepellency(
        ref_data=torch.from_numpy(refs), device="cpu",
        **{**kw, "embed_fn": lambda x: x})
    j_noisy = {k: jnp.asarray(v) for k, v in noisy.items()}
    t_noisy = {k: torch.from_numpy(v) for k, v in noisy.items()}
    for want, got in ((j.empirical_beta(j_noisy, 4.0, 0.3),
                       t.empirical_beta(t_noisy, 4.0, 0.3)),
                      (j.empirical_radius(j_noisy, 0.3),
                       t.empirical_radius(t_noisy, 0.3))):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_kernel_fast_calibrates_beta_from_the_scheduler():
    """A non-positive threshold with a scheduler calibrates: the threshold
    is the last timestep's empirical beta over the bank forward-noised at
    every inference timestep (one generator seeded 42)."""
    from safe_denoiser_tpu_torch.schedulers import DDPMScheduler
    refs = torch.randn(6, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    sch = DDPMScheduler()
    proc = t_methods.get_repellency_method(
        "kernel_fast", ref_data=refs, embed_fn=lambda x: x, num_timesteps=5,
        scheduler=sch, sigma=3.0, beta_threshold=True, quantile=0.5,
        device="cpu")
    noisy = proc.set_noisy_proj_ref(sch, 5)
    assert list(noisy) == [int(t) for t in sch.timesteps(5)]
    want = proc.empirical_beta(noisy, 3.0, 0.5)[1]
    assert proc.beta_threshold == want > 0
    assert proc.config().beta_threshold == want


# ----------------------------------------------------------------- caches
def test_pt_caches_round_trip_with_the_jax_io(tmp_path):
    """torch.save / torch.load against safe_denoiser_tpu.io both ways: the
    projected bank [M,4,64,64] and the noisy-beta dict {t: tensor}."""
    rs = np.random.RandomState(12)
    bank = rs.randn(3, 4, 64, 64).astype(np.float32)
    noisy = {981: rs.randn(3, 4, 64, 64).astype(np.float32),
             1: rs.randn(3, 4, 64, 64).astype(np.float32)}
    proc = t_methods.KernelFastRepellency.__new__(
        t_methods.KernelFastRepellency)
    proc.device = torch.device("cpu")

    j_io.save_pt(bank, tmp_path / "j_bank.pt")
    j_io.save_pt(noisy, tmp_path / "j_noisy.pt")
    got = proc.import_proj_ref(str(tmp_path / "j_bank.pt"))
    np.testing.assert_array_equal(got.numpy(), bank)
    got = proc.import_proj_ref(str(tmp_path / "j_noisy.pt"))
    assert sorted(got) == sorted(noisy)
    for k, v in noisy.items():
        np.testing.assert_array_equal(got[k].numpy(), v)

    torch.save(torch.from_numpy(bank), tmp_path / "t_bank.pt")
    torch.save({k: torch.from_numpy(v) for k, v in noisy.items()},
               tmp_path / "t_noisy.pt")
    np.testing.assert_array_equal(
        np.asarray(j_io.load_pt(tmp_path / "t_bank.pt")), bank)
    back = j_io.load_pt(tmp_path / "t_noisy.pt")
    assert sorted(back) == sorted(noisy)
    for k, v in noisy.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)
