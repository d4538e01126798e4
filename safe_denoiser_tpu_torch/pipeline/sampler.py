"""The sampling loops: SD-v1.x (CFG, latent re-attention or SLD guidance,
SAFREE's per-step swap of the text embeddings, FreeU / SafeGuard through
the UNet, the repellency hook on x0 inside a timestep or step window, the
DDPM or DDIM step) and SD3 (CFG, the flow-match Euler step, the safe
denoiser's renoising inside the window).

Counterpart of ``safe_denoiser_tpu/pipeline/sampler.py::sample_sd`` and
``sample_sd3``. The ``lax.scan`` becomes a Python step loop; the
``lax.cond`` around the repellency hook becomes a host ``if``, so outside
the window the bank is never read. Noise is injected: ``noise_fn(i,
salt)`` returns the step's noise ([B, C, H, W]; salt 1 = the repellency
renoise, 2 = the scheduler's step), so tests can feed the JAX package's
stream and the pipelines their draws from per-seed generators.

The loops can be captured whole into one CUDA graph (``graph.py``): each
step reads its timestep from a device table (``t_table``) and SAFREE's
per-sample mask from the device, and no step copies from the host or
branches on per-request data. The host branches that remain -- the
repellency window (``RepellencyWindow.mask``) and SLD's warm-up -- depend
on the step index alone, so a graph keeps them as it recorded them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..repellency.methods import RepellencyConfig, apply_repellency


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    guidance_scale: float = 7.5
    mode: str = "cfg"               # 'cfg' | 'lra' | 'sld'
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
        # a function of the step (i and its timestep) alone, the same for
        # every request: a CUDA graph of the loop keeps the branch
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
    if guidance.mode in ("cfg", "lra"):
        # lra's third branch only feeds the SafeGuard filters
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
    if i >= guidance.sld_warmup_steps:   # step index only: graph-safe
        noise_guidance = noise_guidance - guidance_safety
    return uncond + g * noise_guidance, momentum


def _check_hook_method(rep_cfg: RepellencyConfig) -> None:
    """The loops' repellency steps pass no generator, so ``random_noise``
    would draw from torch's global RNG: refused, as the JAX package's hooks
    refuse it (they pass no ``rng``). ``apply_repellency`` with an explicit
    ``generator=`` still takes it."""
    if rep_cfg.method == "random_noise":
        raise ValueError("repellency method 'random_noise' needs a generator"
                         " and the sampling loops pass none; call "
                         "apply_repellency(..., generator=) directly")


def _bank_kw(rep_bank) -> dict:
    """``apply_repellency``'s ``bank=``, passed only when there is one."""
    return {} if rep_bank is None else {"bank": rep_bank}


def _repellency_hook(scheduler, eps, t: int, latents, refs, rep_cfg,
                     noise, rep_bank=None):
    """Tweedie x0 -> repellency -> renoise -> replace where negated."""
    _check_hook_method(rep_cfg)
    x0 = scheduler.pred_original_sample(eps, t, latents)
    if isinstance(x0, tuple):       # DDIM returns (x0, eps)
        x0 = x0[0]
    x0_rep, is_neg = apply_repellency(x0, refs, rep_cfg, **_bank_kw(rep_bank))
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
              guidance_scale=None,
              text_embeds_alt: Optional[torch.Tensor] = None,
              use_alt_per_step: Optional[torch.Tensor] = None,
              freeu=None,
              t_table: Optional[torch.Tensor] = None,
              steps: Optional[Sequence[int]] = None,
              rep_bank=None):
    """Run the reverse diffusion for SD-v1.x.

    unet_fn: ``(latents [B', C, H, W], t, context [B', S, D], freeu=)
    -> eps``, the UNet's signature; t is step i's entry of ``t_table``.
    text_embeds: [branches, B, S, D], branch order [uncond, cond, extra]
    (extra: the original cond for 'lra', the safety concept for 'sld').
    latents: [B, C, H, W] initial noise, scaled by init_noise_sigma.
    noise_fn: ``(step index, salt) -> [B, C, H, W]`` noise.
    text_embeds_alt / use_alt_per_step: SAFREE's adaptive window; at step i
    a sample takes its context from ``text_embeds_alt`` where
    ``use_alt_per_step[i]`` ([steps] or [steps, B] bool) holds. The mask
    moves to the device once, and every step selects with it
    (``torch.where``: exactly ``text_embeds`` where it is false).
    freeu: a ``FreeUConfig`` for the UNet.
    t_table: the timesteps as an int64 tensor on the latents' device,
    built once (default: here, before the first step).
    steps: the step indices to run (default all of them; a graph's warm-up
    runs one).
    rep_bank: a ``parallel.ShardedBank``: the repellency runs against the
    M-sharded bank (``refs`` its shards) with summed raw partials.
    Returns (final latents [B, C, H, W], rep_applied [steps, B] bool).
    """
    timesteps = scheduler.timesteps(num_inference_steps)
    if t_table is None:
        t_table = torch.as_tensor(timesteps, device=latents.device)
    n_br, b = text_embeds.shape[0], text_embeds.shape[1]
    if n_br != guidance.branches:
        raise ValueError(f"{n_br} text branches for guidance mode "
                         f"{guidance.mode}")
    ctx = text_embeds.reshape(n_br * b, *text_embeds.shape[2:])
    alt = use = None
    if text_embeds_alt is not None and use_alt_per_step is not None:
        use = torch.as_tensor(use_alt_per_step, dtype=torch.bool,
                              device=ctx.device)
        if use.dim() == 1:
            use = use[:, None].expand(num_inference_steps, b)
        alt = text_embeds_alt.reshape(ctx.shape)
    momentum = torch.zeros_like(latents)
    applied = torch.zeros((num_inference_steps, b), dtype=torch.bool,
                          device=latents.device)
    for i in range(num_inference_steps) if steps is None else steps:
        t = int(timesteps[i])
        latent_in = scheduler.scale_model_input(
            torch.cat([latents] * n_br, dim=0), t)
        step_ctx = ctx
        if alt is not None:
            rows = use[i].repeat(n_br)
            step_ctx = torch.where(rows[:, None, None], alt, ctx)
        eps = unet_fn(latent_in, t_table[i], step_ctx, freeu=freeu)
        eps = eps.reshape(n_br, b, *eps.shape[1:])
        eps, momentum = _combine_guidance(eps, i, guidance, momentum,
                                          guidance_scale)
        if repellency is not None and window.mask(i, t):
            latents, applied[i] = _repellency_hook(
                scheduler, eps, t, latents, refs, repellency,
                noise_fn(i, 1), rep_bank)
        latents, _ = scheduler.step(eps, t, latents, num_inference_steps,
                                    noise=noise_fn(i, 2))
    return latents, applied


def sample_sd3(transformer_fn: Callable[..., torch.Tensor],
               scheduler: Any,
               text_embeds: torch.Tensor,
               pooled_embeds: torch.Tensor,
               latents: torch.Tensor,
               noise_fn: Callable[[int, int], torch.Tensor],
               num_inference_steps: int,
               guidance_scale=7.0,
               repellency: Optional[RepellencyConfig] = None,
               refs: Optional[torch.Tensor] = None,
               window: RepellencyWindow = RepellencyWindow(),
               steps: Optional[Sequence[int]] = None,
               rep_bank=None):
    """The SD3 flow-matching loop with the safe denoiser's renoising.
    Inside the window, with sigma_+ the next sigma:

        x0 = x - sigma v,  x1 = x + (1 - sigma) v,  x0' = repellency(x0),
        n = sqrt(sigma_+) x1 + sqrt(1 - sigma_+) eps,
        x <- x0' + sigma_+ (n - x0')   where the sample is negated,

    else the Euler step x <- x + (sigma_+ - sigma) v.

    transformer_fn: ``(latents [2B, C, H, W], t [2B], context [2B, S, D],
    pooled [2B, P]) -> v`` (f32). text_embeds [2, B, S, D] and pooled
    [2, B, P] are (uncond, cond). ``guidance_scale`` is a scalar or a [B]
    tensor. ``noise_fn(i, 1)`` gives step i's renoise eps [B, C, H, W].
    Each step's t is a ``torch.full`` on the device (a fill, no host copy).
    ``steps``: the step indices to run (default all of them).
    ``rep_bank``: as ``sample_sd``'s.
    Returns (final latents [B, C, H, W], rep_applied [steps, B] bool)."""
    timesteps, sigmas = scheduler.timesteps_and_sigmas(num_inference_steps)
    b = latents.shape[0]
    ctx = text_embeds.reshape(2 * b, *text_embeds.shape[2:])
    pooled = pooled_embeds.reshape(2 * b, *pooled_embeds.shape[2:])
    gs = guidance_scale
    if torch.is_tensor(gs) and gs.dim() == 1:
        gs = gs.reshape(-1, 1, 1, 1)
    applied = torch.zeros((num_inference_steps, b), dtype=torch.bool,
                          device=latents.device)
    f32 = np.float32
    for i in range(num_inference_steps) if steps is None else steps:
        t, sigma, sigma_next = timesteps[i], sigmas[i], sigmas[i + 1]
        t_in = torch.full((2 * b,), float(t), dtype=torch.float32,
                          device=latents.device)
        v = transformer_fn(torch.cat([latents, latents]), t_in, ctx, pooled)
        v = v[:b] + gs * (v[b:] - v[:b])
        # the scalars in f32, as the JAX package's f32 tables give them
        euler = latents + float(f32(sigma_next - sigma)) * v
        if repellency is None or not window.mask(i, float(t)):
            latents = euler
            continue
        x0 = latents - float(sigma) * v
        x1 = latents + float(f32(1.0) - sigma) * v
        _check_hook_method(repellency)
        x0_rep, is_neg = apply_repellency(x0, refs, repellency,
                                          **_bank_kw(rep_bank))
        noise = (float(np.sqrt(sigma_next)) * x1
                 + float(np.sqrt(f32(1.0) - sigma_next)) * noise_fn(i, 1))
        renoised = x0_rep + float(sigma_next) * (noise - x0_rep)
        latents = torch.where(is_neg[:, None, None, None], renoised, euler)
        applied[i] = is_neg
    return latents, applied
