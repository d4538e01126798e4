"""The port's DDIM scheduler and the SD-v1 loop under it against the JAX
package on the CPU (f32).

The scheduler is held against the golden rows (diffusers' DDIM transcribed
in torch) and against ``safe_denoiser_tpu.schedulers.DDIMScheduler``:
tables, timesteps under each spacing, ``step``, ``pred_original_sample``
and ``add_noise`` (eta 0, and eta 0.5 on injected noise). The loop runs
both packages' ``sample_sd`` on the same tiny UNet and the JAX package's
noise stream (tests/test_torch_port_sampler.py), the repellency window
open, so the hook's (x0, eps) unwrapping is exercised.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.pipeline import sampler as j_sampler
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu.schedulers import DDIMConfig as JDDIMConfig
from safe_denoiser_tpu.schedulers import DDIMScheduler as JDDIMScheduler
from safe_denoiser_tpu_torch.pipeline import (
    EraseSpec, RepellencyWindow, SafeDiffusionPipeline)
from safe_denoiser_tpu_torch.pipeline import sampler as t_sampler
from safe_denoiser_tpu_torch.repellency import KernelFastRepellency
from safe_denoiser_tpu_torch.repellency import methods as t_methods
from safe_denoiser_tpu_torch.schedulers import DDIMConfig, DDIMScheduler
from tests.test_torch_port_models import jax_unet, torch_unet
from tests.test_torch_port_pipeline import (  # noqa: F401 (a fixture)
    _write_checkpoint, vocab_dir)
from tests.test_torch_port_sampler import (B, H_LAT, RNG, STEPS, _jax_noise)

GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                     "scheduler_golden.json")))
SAMPLE = np.asarray([0.73, -1.91, 0.244, 3.5], np.float32)
EPS = np.asarray([-0.31, 0.62, -1.55, 0.09], np.float32)


@pytest.mark.parametrize("row", GOLDEN["ddim"],
                         ids=lambda r: f"t{r['t']}_eta{r['eta']}_"
                         f"{r['pred_type']}{'_uc' if r['use_clipped'] else ''}"
                         f"{'_sa1' if r['set_alpha_to_one'] else ''}")
def test_ddim_step_golden(row):
    sched = DDIMScheduler(DDIMConfig(
        clip_sample=row["clip"], prediction_type=row["pred_type"],
        eta=row["eta"], use_clipped_model_output=row["use_clipped"],
        set_alpha_to_one=row["set_alpha_to_one"]))
    s, e = torch.from_numpy(SAMPLE), torch.from_numpy(EPS)
    prev, x0 = sched.step(e, row["t"], s, row["steps"], noise=torch.zeros(4))
    np.testing.assert_allclose(x0.numpy(), row["x0"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(prev.numpy(), row["prev"], rtol=2e-5,
                               atol=1e-6)
    if row["eta"] > 0:
        prev_n, _ = sched.step(e, row["t"], s, row["steps"],
                               noise=torch.ones(4))
        np.testing.assert_allclose(float((prev_n - prev)[0]), row["std"],
                                   rtol=2e-5)
        with pytest.raises(ValueError, match="noise"):
            sched.step(e, row["t"], s, row["steps"])


@pytest.mark.parametrize("steps", [10, 50])
@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_ddim_timesteps_match_jax(spacing, steps):
    cfg = dict(timestep_spacing=spacing)
    np.testing.assert_array_equal(
        DDIMScheduler(DDIMConfig(**cfg)).timesteps(steps),
        JDDIMScheduler(JDDIMConfig(**cfg)).timesteps(steps))
    if (spacing, steps) == ("leading", 10):
        # the 10-step configuration: 901 and 801 lie in [1000, 780]
        assert DDIMScheduler().timesteps(10).tolist() == list(
            range(901, 0, -100))


@pytest.mark.parametrize("cfg", [
    DDIMConfig(), DDIMConfig(eta=0.5),
    DDIMConfig(prediction_type="v_prediction", timestep_spacing="trailing",
               beta_schedule="linear"),
    DDIMConfig(prediction_type="sample", timestep_spacing="linspace",
               clip_sample=True, use_clipped_model_output=True, eta=0.5),
    DDIMConfig(set_alpha_to_one=True, clip_sample=True)],
    ids=["sd14", "eta0.5", "v_trailing", "sample_clip_eta", "alpha_one"])
def test_ddim_matches_jax_scheduler(cfg):
    js = JDDIMScheduler(JDDIMConfig(**dataclasses.asdict(cfg)))
    ts = DDIMScheduler(cfg)
    np.testing.assert_array_equal(ts.alphas_cumprod,
                                  np.asarray(js.alphas_cumprod))
    assert float(ts.final_alpha_cumprod) == float(js.final_alpha_cumprod)
    rs = np.random.RandomState(0)
    x, e, n = (rs.randn(2, 4, 3, 3).astype(np.float32) for _ in range(3))
    tx, te, tn = (torch.from_numpy(a) for a in (x, e, n))
    jx, je, jn = (jnp.asarray(a) for a in (x, e, n))
    for steps in (10, 50):
        for t in (int(v) for v in ts.timesteps(steps)[::3]):
            wp, wx = js.step(je, jnp.asarray(t), jx, steps, noise=jn)
            gp, gx = ts.step(te, t, tx, steps, noise=tn)
            np.testing.assert_allclose(gp.numpy(), np.asarray(wp),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(gx.numpy(), np.asarray(wx),
                                       rtol=1e-6, atol=1e-6)
            for g, w in zip(ts.pred_original_sample(te, t, tx),
                            js.pred_original_sample(je, jnp.asarray(t), jx)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                ts.add_noise(tx, tn, t).numpy(),
                np.asarray(js.add_noise(jx, jn, jnp.asarray(t))),
                rtol=1e-6, atol=1e-6)


def test_sample_sd_with_ddim_matches_jax():
    """The loop under DDIM (the configuration's eta 0) on the JAX noise
    stream, kernel_fast repellency in [1000, 300]: the hook unwraps the
    scheduler's (x0, eps)."""
    model, params = jax_unet()
    tu = torch_unet(params)
    rs = np.random.RandomState(6)
    lat0 = rs.randn(B, 4, H_LAT, H_LAT).astype(np.float32)
    ctx = rs.randn(2, B, 5, 32).astype(np.float32)
    refs = rs.randn(8, 4, H_LAT, H_LAT).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    kw = dict(method="kernel_fast", sigma=30.0, scale=0.4, epsilon=1e-8,
              beta_threshold=1e-12, use_beta_gate=True)
    window = dict(t_start=1000.0, t_end=300.0)
    want, w_applied = j_sampler.sample_sd(
        lambda lat, t, c, fu: model.apply(params, lat, t, c),
        JDDIMScheduler(), jnp.asarray(ctx),
        jnp.asarray(lat0.transpose(0, 2, 3, 1)), RNG, STEPS,
        repellency=j_methods.RepellencyConfig(**kw),
        refs_nchw=jnp.asarray(refs),
        window=j_sampler.RepellencyWindow(**window))
    with torch.no_grad():
        got, applied = t_sampler.sample_sd(
            tu, DDIMScheduler(), torch.from_numpy(ctx),
            torch.from_numpy(lat0), _jax_noise, STEPS,
            repellency=t_methods.RepellencyConfig(**kw),
            refs=torch.from_numpy(refs),
            window=t_sampler.RepellencyWindow(**window))
    assert applied.any(), "repellency never fired"
    np.testing.assert_array_equal(applied.numpy(), np.asarray(w_applied))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=2e-3, rtol=1e-3)


def test_pipeline_runs_the_ddim_configuration(
        tmp_path, vocab_dir):  # noqa: F811
    """``from_pretrained(scheduler=DDIMScheduler())`` on a tiny checkpoint
    runs the 10-step configuration's loop unchanged (here 4 steps, t = 751
    ... 1, the window [1000, 300] holding the first two): the hook fires
    at those steps, the images are uint8."""
    root = str(tmp_path / "ckpt")
    _write_checkpoint(root, vocab_dir)
    pipe = SafeDiffusionPipeline.from_pretrained(
        root, scheduler=DDIMScheduler(DDIMConfig()), device="cpu",
        dtype=torch.float32)
    bank = torch.randn(5, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    proc = KernelFastRepellency(ref_data=bank, embed_fn=lambda x: x,
                                sigma=30.0, scale=0.3, beta_threshold=1e-12,
                                device="cpu")
    pending = pipe.dispatch_batch(
        ["a cat", "a dog"], [1, 2], [7.5, 7.5], num_inference_steps=4,
        height=16, width=16, repellency_processor=proc,
        erase_spec=EraseSpec(repellency=True,
                             window=RepellencyWindow(1000.0, 300.0)))
    images = pending.fetch()
    assert pipe.scheduler.timesteps(4).tolist() == [751, 501, 251, 1]
    assert pending.applied.any(1).tolist() == [True, True, False, False]
    assert [im.shape for im in images] == [(16, 16, 3)] * 2
    assert all(im.dtype == np.uint8 for im in images)
    assert bool(torch.isfinite(pending.latents).all())
