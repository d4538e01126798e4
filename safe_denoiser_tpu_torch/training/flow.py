"""Flow-matching training steps for the SD3 family (MMDiT).

Counterpart of ``safe_denoiser_tpu/training/flow.py``: rectified-flow
velocity regression with SD3's logit-normal timestep density, in the
sampler's conventions (``pipeline/sampler.py::sample_sd3``): x_s =
(1 - s) x0 + s eps, the model predicts v = eps - x0, and its timestep
input is t = s * num_train_timesteps. Latents are NCHW, as the port's
MMDiT takes them.
"""

from __future__ import annotations

from typing import Callable

import torch

from .esd import ESDConfig, _draw_noise, optimizer_step


def sample_sigmas_logit_normal(generator: torch.Generator, batch: int,
                               mean: float = 0.0, std: float = 1.0
                               ) -> torch.Tensor:
    """SD3's logit-normal density: sigmoid(N(mean, std^2)), [batch] f32 on
    the generator's device."""
    z = torch.randn((batch,), generator=generator, device=generator.device)
    return torch.sigmoid(mean + std * z)


def flow_matching_loss(apply_fn: Callable, params, x0: torch.Tensor,
                       ctx: torch.Tensor, pooled: torch.Tensor,
                       sigma: torch.Tensor, noise,
                       num_train_timesteps: int = 1000) -> torch.Tensor:
    """The rectified-flow MSE at per-sample noise levels sigma in (0, 1), in
    f32. x0 [B, C, H, W]; ctx [B, S, D]; pooled [B, P]; sigma [B];
    ``noise``: eps, or a ``torch.Generator`` to draw it from."""
    noise = _draw_noise(noise, x0)
    sig = sigma.reshape((-1,) + (1,) * (x0.dim() - 1)).to(x0.dtype)
    x_sig = (1.0 - sig) * x0 + sig * noise
    t = (sigma * num_train_timesteps).float()
    pred = apply_fn(params, x_sig, t, ctx, pooled)
    target = noise.float() - x0.float()
    return torch.mean(torch.square(pred.float() - target))


def make_flow_train_step(apply_fn: Callable, cfg: ESDConfig = ESDConfig(),
                         num_train_timesteps: int = 1000) -> Callable:
    """One flow-matching update: ``step(params, opt, x0, ctx, pooled,
    sigma, noise) -> (params, opt, loss)``; ``opt`` is
    ``make_optimizer(cfg, params, mask)``."""
    def step(params, opt, x0, ctx, pooled, sigma, noise):
        loss = flow_matching_loss(apply_fn, params, x0, ctx, pooled, sigma,
                                  noise, num_train_timesteps)
        optimizer_step(opt, loss, cfg)
        return params, opt, loss.detach()

    return step
