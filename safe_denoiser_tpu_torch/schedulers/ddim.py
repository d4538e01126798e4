"""DDIM scheduler (diffusers ``DDIMScheduler`` semantics, SD-v1.4 config).

Counterpart of ``safe_denoiser_tpu/schedulers/ddim.py``, the scheduler of
the 10-step DDIM configuration. As ``DDPMScheduler``, whose tables (a
float64 cumprod of the f32 alphas, cast to f32), timesteps and
``add_noise`` it shares: the timestep is a host integer, every per-step
coefficient is computed on the host in float32 numpy (the JAX tables' f32
arithmetic) and enters the tensor math as a scalar. With ``eta > 0`` the
step's noise is passed in (``noise=``); the scheduler never draws it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ddpm import DDPMScheduler

_f32 = np.float32


@dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"
    steps_offset: int = 1
    eta: float = 0.0
    # diffusers recomputes epsilon from the clipped x0 only when the caller
    # passes use_clipped_model_output=True (default False)
    use_clipped_model_output: bool = False


class DDIMScheduler(DDPMScheduler):
    """The DDPM scheduler's tables, timesteps and ``add_noise`` with the
    DDIM step."""

    def __init__(self, config: DDIMConfig = DDIMConfig()):
        super().__init__(config)
        self.final_alpha_cumprod = (_f32(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])

    def _alpha_prod_prev(self, t: int, num_inference_steps: int) -> np.float32:
        n_train = self.config.num_train_timesteps
        prev_t = int(t) - n_train // num_inference_steps
        return (self.alphas_cumprod[prev_t] if prev_t >= 0
                else self.final_alpha_cumprod)

    def pred_original_sample(self, model_output: torch.Tensor, t: int,
                             sample: torch.Tensor):
        """(x0, eps): the Tweedie x0 estimate (clipped with clip_sample) and
        the noise it implies."""
        apt = self.alphas_cumprod[int(t)]
        bpt = _f32(1.0) - apt
        sa, sb = float(apt ** _f32(0.5)), float(bpt ** _f32(0.5))
        if self.config.prediction_type == "epsilon":
            x0 = (sample - sb * model_output) / sa
            eps = model_output
        elif self.config.prediction_type == "v_prediction":
            x0 = sa * sample - sb * model_output
            eps = sa * model_output + sb * sample
        else:  # "sample"
            x0 = model_output
            eps = (sample - sa * x0) / sb
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
        return x0, eps

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             num_inference_steps: int, noise: torch.Tensor | None = None):
        """One reverse step x_t -> x_{t-1}; returns (prev_sample, x0). With
        eta > 0 ``noise`` is required."""
        eta = _f32(self.config.eta)
        apt = self.alphas_cumprod[int(t)]
        aptp = self._alpha_prod_prev(t, num_inference_steps)
        bpt = _f32(1.0) - apt

        x0, eps = self.pred_original_sample(model_output, t, sample)
        if self.config.clip_sample and self.config.use_clipped_model_output:
            eps = (sample - float(apt ** _f32(0.5)) * x0) \
                / float(bpt ** _f32(0.5))
        variance = (_f32(1.0) - aptp) / (_f32(1.0) - apt) \
            * (_f32(1.0) - apt / aptp)
        std = eta * variance ** _f32(0.5)
        direction = float((_f32(1.0) - aptp - std ** 2) ** _f32(0.5)) * eps
        prev = float(aptp ** _f32(0.5)) * x0 + direction
        if eta > 0:
            if noise is None:
                raise ValueError("DDIM with eta > 0 needs the step's noise")
            prev = prev + float(std) * noise
        return prev, x0
