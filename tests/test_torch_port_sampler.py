"""The port's scheduler, repellency methods and sampling loop against the
JAX package on the CPU (f32).

The sampling loop runs both packages on the same tiny UNet weights and the
same noise: the port's loop takes injected noise, and the test feeds it the
JAX package's threefry stream (fold_in(fold_in(key, i), salt)), so any
mismatch is loop logic, not RNG. sigma=30 keeps the RBF weights from
underflowing to 0 on random latents.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.pipeline import sampler as j_sampler
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu.schedulers import DDPMConfig as JDDPMConfig
from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPMScheduler
from safe_denoiser_tpu_torch.pipeline import sampler as t_sampler
from safe_denoiser_tpu_torch.repellency import methods as t_methods
from safe_denoiser_tpu_torch.schedulers import DDPMConfig, DDPMScheduler
from tests.test_torch_port_models import jax_unet, torch_unet

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                     "scheduler_golden.json")))
SAMPLE = np.asarray([0.73, -1.91, 0.244, 3.5], np.float32)
EPS = np.asarray([-0.31, 0.62, -1.55, 0.09], np.float32)


# ---------------------------------------------------------------- scheduler
@pytest.mark.parametrize("row", GOLDEN["ddpm"],
                         ids=lambda r: f"t{r['t']}_{r['pred_type']}"
                         f"{'_clip' if r['clip'] else ''}")
def test_ddpm_step_golden(row):
    sched = DDPMScheduler(DDPMConfig(clip_sample=row["clip"],
                                     prediction_type=row["pred_type"]))
    s, e = torch.from_numpy(SAMPLE), torch.from_numpy(EPS)
    prev, x0 = sched.step(e, row["t"], s, row["steps"],
                          noise=torch.zeros(4))
    np.testing.assert_allclose(x0.numpy(), row["x0"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(prev.numpy(), row["prev"], rtol=2e-5,
                               atol=1e-6)
    big = 1e8
    prev_n, _ = sched.step(e, row["t"], s, row["steps"],
                           noise=torch.full((4,), big))
    if row["t"] > 0:
        np.testing.assert_allclose(float((prev_n - prev)[0]) / big,
                                   row["std"], rtol=1e-4)


def test_add_noise_and_tables_golden():
    sched = DDPMScheduler()
    for t, want in GOLDEN["alphas_cumprod_probe"].items():
        np.testing.assert_allclose(float(sched.alphas_cumprod[int(t)]), want,
                                   rtol=1e-6)
    for row in GOLDEN["add_noise"]:
        got = sched.add_noise(torch.from_numpy(SAMPLE),
                              torch.from_numpy(EPS), row["t"])
        np.testing.assert_allclose(got.numpy(), row["noised"], rtol=2e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("cfg", [DDPMConfig(), DDPMConfig(
    beta_schedule="linear", timestep_spacing="trailing",
    prediction_type="v_prediction", variance_type="fixed_small_log")],
    ids=["sd14", "variant"])
def test_ddpm_matches_jax_scheduler(cfg):
    js = JDDPMScheduler(JDDPMConfig(**dataclasses.asdict(cfg)))
    ts = DDPMScheduler(cfg)
    np.testing.assert_array_equal(ts.timesteps(50), js.timesteps(50))
    np.testing.assert_array_equal(ts.alphas_cumprod,
                                  np.asarray(js.alphas_cumprod))
    rs = np.random.RandomState(0)
    x, e, n = (rs.randn(2, 4, 3, 3).astype(np.float32) for _ in range(3))
    for t in (int(v) for v in ts.timesteps(50)[::7]):
        wp, wx = js.step(jnp.asarray(e), jnp.asarray(t), jnp.asarray(x), 50,
                         noise=jnp.asarray(n))
        gp, gx = ts.step(torch.from_numpy(e), t, torch.from_numpy(x), 50,
                         noise=torch.from_numpy(n))
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------- repellency
@pytest.mark.parametrize("method", ["kernel_fast", "euclidean", "sparse"])
@pytest.mark.parametrize("normalize_x", [False, True])
def test_apply_repellency_matches_jax(method, normalize_x):
    rs = np.random.RandomState(1)
    refs = rs.randn(9, 4, 8, 8).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    x0 = (refs[:3] + 0.3 * rs.randn(3, 4, 8, 8)).astype(np.float32)
    kw = dict(method=method, sigma=30.0, scale=0.4, beta_threshold=1.5,
              radius=12.0, normalize_x=normalize_x)
    wx, wn = j_methods.apply_repellency(
        jnp.asarray(x0), jnp.asarray(refs), j_methods.RepellencyConfig(**kw))
    gx, gn = t_methods.apply_repellency(
        torch.from_numpy(x0), torch.from_numpy(refs),
        t_methods.RepellencyConfig(**kw))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


def test_random_noise_method_shape_and_gate():
    x0 = torch.randn(2, 4, 8, 8)
    out, neg = t_methods.apply_repellency(
        x0, torch.randn(3, 4, 8, 8), t_methods.RepellencyConfig(
            method="random_noise", scale=0.1),
        generator=torch.Generator().manual_seed(0))
    assert out.shape == x0.shape and bool(neg.all())


def test_kernel_fast_processor_bank_and_config(tmp_path):
    rs = np.random.RandomState(2)
    data = rs.randn(5, 4, 8, 8).astype(np.float32)
    kw = dict(sigma=3.15, scale=0.33, beta_threshold=7.0, n_embed=2)
    path = str(tmp_path / "bank.pt")
    jp = j_methods.KernelFastRepellency(
        ref_data=jnp.asarray(data), embed_fn=lambda x: x, **kw)
    tp = t_methods.KernelFastRepellency(
        ref_data=torch.from_numpy(data), embed_fn=lambda x: x,
        proj_ref_path=path, device="cpu", **kw)
    assert dataclasses.asdict(tp.config()) == dataclasses.asdict(jp.config())
    np.testing.assert_allclose(tp.get_proj_ref().numpy(),
                               np.asarray(jp.get_proj_ref()), rtol=1e-6)
    cached = t_methods.KernelFastRepellency(
        ref_data=None, embed_fn=None, proj_ref_path=path,
        cache_proj_ref=True, device="cpu", **kw)
    np.testing.assert_array_equal(cached.get_proj_ref().numpy(),
                                  tp.get_proj_ref().numpy())
    # a non-positive threshold with a scheduler is calibrated: the last
    # timestep's empirical beta over the forward-noised bank (the noise
    # differs from JAX's; test_torch_port_conv.py holds empirical_beta
    # against the JAX package on injected noisy banks)
    calibrated = t_methods.KernelFastRepellency(
        ref_data=torch.from_numpy(data), embed_fn=lambda x: x,
        beta_threshold=-1.0, scheduler=DDPMScheduler(), num_timesteps=5,
        device="cpu")
    noisy = calibrated.set_noisy_proj_ref(DDPMScheduler(), 5)
    want = calibrated.empirical_beta(noisy, 1.0, 0.0)[1]
    assert calibrated.beta_threshold == want > 0


# ------------------------------------------------------------ sampling loop
B, H_LAT, STEPS = 2, 8, 5
RNG = jax.random.PRNGKey(1234)


def _jax_noise(i: int, salt: int) -> torch.Tensor:
    k = jax.random.fold_in(jax.random.fold_in(RNG, i), salt)
    n = jax.random.normal(k, (B, H_LAT, H_LAT, 4), dtype=jnp.float32)
    return torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("mode,window", [
    ("cfg", dict(t_start=1000.0, t_end=300.0)),
    ("sld", dict(step_start=1, step_end=3, by_timestep=False)),
], ids=["cfg-window-by-timestep", "sld-window-by-step"])
def test_sample_sd_matches_jax(mode, window):
    model, params = jax_unet()
    tu = torch_unet(params)
    rs = np.random.RandomState(5)
    lat0 = rs.randn(B, 4, H_LAT, H_LAT).astype(np.float32)
    ctx3 = rs.randn(3, B, 5, 32).astype(np.float32)
    refs = rs.randn(8, 4, H_LAT, H_LAT).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    kw = dict(method="kernel_fast", sigma=30.0, scale=0.4, epsilon=1e-8,
              beta_threshold=1e-12, use_beta_gate=True)
    gkw = dict(mode=mode, sld_warmup_steps=2)
    n_br = 2 if mode == "cfg" else 3

    want, w_applied = j_sampler.sample_sd(
        lambda lat, t, c, fu: model.apply(params, lat, t, c),
        JDDPMScheduler(), jnp.asarray(ctx3[:n_br]),
        jnp.asarray(lat0.transpose(0, 2, 3, 1)), RNG, STEPS,
        guidance=j_sampler.GuidanceConfig(**gkw),
        repellency=j_methods.RepellencyConfig(**kw),
        refs_nchw=jnp.asarray(refs),
        window=j_sampler.RepellencyWindow(**window))
    with torch.no_grad():
        got, applied = t_sampler.sample_sd(
            tu, DDPMScheduler(), torch.from_numpy(ctx3[:n_br]),
            torch.from_numpy(lat0), _jax_noise, STEPS,
            guidance=t_sampler.GuidanceConfig(**gkw),
            repellency=t_methods.RepellencyConfig(**kw),
            refs=torch.from_numpy(refs),
            window=t_sampler.RepellencyWindow(**window))
    assert applied.any(), "repellency never fired"
    np.testing.assert_array_equal(applied.numpy(), np.asarray(w_applied))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=2e-3, rtol=1e-3)
