"""The SD-v1.x sampling loop: CFG / SLD guidance, the repellency hook on
x0 inside a timestep (or step) window, and the DDPM step.

Counterpart of ``safe_denoiser_tpu/pipeline/sampler.py::sample_sd``. The
``lax.scan`` becomes a Python step loop; the ``lax.cond`` around the
repellency hook becomes a host ``if``, so outside the window the bank is
never read. Noise is injected: ``noise_fn(i, salt)`` returns the step's
noise ([B, C, H, W]; salt 1 = the repellency renoise, 2 = the scheduler
step), so tests can feed the JAX package's stream and the pipeline its own
per-seed generators.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..repellency.methods import RepellencyConfig, apply_repellency


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    guidance_scale: float = 7.5
    mode: str = "cfg"               # 'cfg' | 'sld' (lra waits for SAFREE)
    sld_guidance_scale: float = 2000.0
    sld_threshold: float = 0.025
    sld_momentum_scale: float = 0.5
    sld_mom_beta: float = 0.7
    sld_warmup_steps: int = 7

    @property
    def branches(self) -> int:
        return 2 if self.mode == "cfg" else 3


@dataclasses.dataclass(frozen=True)
class RepellencyWindow:
    """Apply the hook when t_end <= t <= t_start (``by_timestep``) or when
    step_start <= i <= step_end."""

    t_start: float = 1000.0
    t_end: float = 780.0
    step_start: int = 0
    step_end: int = 10 ** 9
    by_timestep: bool = True

    def mask(self, i: int, t: int) -> bool:
        if self.by_timestep:
            return self.t_end <= t <= self.t_start
        return self.step_start <= i <= self.step_end


def _combine_guidance(noise_pred: torch.Tensor, i: int,
                      guidance: GuidanceConfig, momentum: torch.Tensor,
                      guidance_scale=None):
    """[branches, B, ...] model outputs -> (guided eps [B, ...], momentum).
    ``guidance_scale`` may be a [B] tensor of per-sample scales."""
    uncond, text = noise_pred[0], noise_pred[1]
    g = guidance.guidance_scale if guidance_scale is None else guidance_scale
    if torch.is_tensor(g) and g.dim() == 1:
        g = g.reshape(-1, *([1] * (uncond.dim() - 1)))
    if guidance.mode == "cfg":
        return uncond + g * (text - uncond), momentum
    if guidance.mode != "sld":
        raise NotImplementedError(f"guidance mode {guidance.mode}")
    # Safe Latent Diffusion, Eqs. 3-8
    safety = noise_pred[2]
    noise_guidance = text - uncond
    scale = torch.clamp(torch.abs(text - safety)
                        * guidance.sld_guidance_scale, max=1.0)
    safety_scale = torch.where(text - safety >= guidance.sld_threshold,
                               torch.zeros_like(scale), scale)
    guidance_safety = (safety - uncond) * safety_scale
    guidance_safety = guidance_safety + guidance.sld_momentum_scale * momentum
    momentum = (guidance.sld_mom_beta * momentum
                + (1.0 - guidance.sld_mom_beta) * guidance_safety)
    if i >= guidance.sld_warmup_steps:
        noise_guidance = noise_guidance - guidance_safety
    return uncond + g * noise_guidance, momentum


def _repellency_hook(scheduler, eps, t: int, latents, refs, rep_cfg,
                     noise):
    """Tweedie x0 -> repellency -> renoise -> replace where negated."""
    x0 = scheduler.pred_original_sample(eps, t, latents)
    x0_rep, is_neg = apply_repellency(x0, refs, rep_cfg)
    renoised = scheduler.add_noise(x0_rep, noise, t)
    return (torch.where(is_neg[:, None, None, None], renoised, latents),
            is_neg)


def sample_sd(unet_fn: Callable[..., torch.Tensor],
              scheduler: Any,
              text_embeds: torch.Tensor,
              latents: torch.Tensor,
              noise_fn: Callable[[int, int], torch.Tensor],
              num_inference_steps: int,
              guidance: GuidanceConfig = GuidanceConfig(),
              repellency: Optional[RepellencyConfig] = None,
              refs: Optional[torch.Tensor] = None,
              window: RepellencyWindow = RepellencyWindow(),
              guidance_scale=None):
    """Run the reverse diffusion for SD-v1.x.

    unet_fn: ``(latents [B', C, H, W], t, context [B', S, D]) -> eps``.
    text_embeds: [branches, B, S, D], branch order [uncond, cond, extra].
    latents: [B, C, H, W] initial noise, scaled by init_noise_sigma.
    noise_fn: ``(step index, salt) -> [B, C, H, W]`` noise.
    Returns (final latents [B, C, H, W], rep_applied [steps, B] bool).
    """
    timesteps = scheduler.timesteps(num_inference_steps)
    n_br, b = text_embeds.shape[0], text_embeds.shape[1]
    if n_br != guidance.branches:
        raise ValueError(f"{n_br} text branches for guidance mode "
                         f"{guidance.mode}")
    ctx = text_embeds.reshape(n_br * b, *text_embeds.shape[2:])
    momentum = torch.zeros_like(latents)
    applied = torch.zeros((num_inference_steps, b), dtype=torch.bool,
                          device=latents.device)
    for i, t in enumerate(int(t) for t in timesteps):
        latent_in = scheduler.scale_model_input(
            torch.cat([latents] * n_br, dim=0), t)
        eps = unet_fn(latent_in, t, ctx)
        eps = eps.reshape(n_br, b, *eps.shape[1:])
        eps, momentum = _combine_guidance(eps, i, guidance, momentum,
                                          guidance_scale)
        if repellency is not None and window.mask(i, t):
            latents, applied[i] = _repellency_hook(
                scheduler, eps, t, latents, refs, repellency,
                noise_fn(i, 1))
        latents, _ = scheduler.step(eps, t, latents, num_inference_steps,
                                    noise=noise_fn(i, 2))
    return latents, applied
