"""DDPM scheduler (diffusers ``DDPMScheduler`` semantics, SD-v1.4 config).

Counterpart of ``safe_denoiser_tpu/schedulers/ddpm.py``. The timestep is a
host integer (the sampling loop is a Python loop), so every per-step
coefficient is computed on the host in float32 numpy -- the same f32
arithmetic as the JAX tables -- and enters the tensor math as a scalar.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
               beta_schedule: str = "scaled_linear") -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64).astype(np.float32)
    if beta_schedule == "scaled_linear":
        return (np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
                ).astype(np.float32)
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(num_train_timesteps, dtype=np.float64)
        betas = 1.0 - (alpha_bar((ts + 1) / num_train_timesteps)
                       / alpha_bar(ts / num_train_timesteps))
        return np.minimum(betas, 0.999).astype(np.float32)
    raise ValueError(f"unknown beta_schedule {beta_schedule}")


@dataclass(frozen=True)
class DDPMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"
    variance_type: str = "fixed_small"
    timestep_spacing: str = "leading"
    steps_offset: int = 1


_f32 = np.float32


class DDPMScheduler:
    def __init__(self, config: DDPMConfig = DDPMConfig()):
        self.config = config
        betas = make_betas(config.num_train_timesteps, config.beta_start,
                           config.beta_end, config.beta_schedule)
        self.alphas_cumprod = np.cumprod(1.0 - betas, dtype=np.float64
                                         ).astype(np.float32)
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """'leading' spacing with steps_offset, like diffusers set_timesteps."""
        n_train = self.config.num_train_timesteps
        if self.config.timestep_spacing == "leading":
            step_ratio = n_train // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * step_ratio
                  ).round()[::-1].astype(np.int64)
            ts += self.config.steps_offset
        elif self.config.timestep_spacing == "trailing":
            step_ratio = n_train / num_inference_steps
            ts = np.round(np.arange(n_train, 0, -step_ratio)).astype(
                np.int64) - 1
        else:  # linspace
            ts = np.linspace(0, n_train - 1, num_inference_steps
                             ).round()[::-1].astype(np.int64)
        return ts

    def _alpha_prod(self, t: int) -> np.float32:
        return self.alphas_cumprod[int(t)]

    def _alpha_prod_prev(self, t: int, num_inference_steps: int) -> np.float32:
        prev_t = int(t) - self.config.num_train_timesteps // num_inference_steps
        return self.alphas_cumprod[prev_t] if prev_t >= 0 else _f32(1.0)

    def scale_model_input(self, sample: torch.Tensor, t) -> torch.Tensor:
        return sample

    def pred_original_sample(self, model_output: torch.Tensor, t: int,
                             sample: torch.Tensor) -> torch.Tensor:
        """Tweedie x0 estimate (the repellency hook's input)."""
        apt = self._alpha_prod(t)
        bpt = _f32(1.0) - apt
        if self.config.prediction_type == "epsilon":
            x0 = (sample - float(bpt ** _f32(0.5)) * model_output) \
                / float(apt ** _f32(0.5))
        elif self.config.prediction_type == "v_prediction":
            x0 = float(apt ** _f32(0.5)) * sample \
                - float(bpt ** _f32(0.5)) * model_output
        else:  # "sample"
            x0 = model_output
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
        return x0

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             num_inference_steps: int, noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None):
        """One reverse step x_t -> x_{t-1}; returns (prev_sample, x0).
        ``noise`` may be given (the sampler injects per-sample noise);
        otherwise it is drawn from ``generator``."""
        apt = self._alpha_prod(t)
        aptp = self._alpha_prod_prev(t, num_inference_steps)
        bpt = _f32(1.0) - apt
        bptp = _f32(1.0) - aptp
        cur_alpha = apt / aptp
        cur_beta = _f32(1.0) - cur_alpha

        x0 = self.pred_original_sample(model_output, t, sample)
        orig_coeff = (aptp ** _f32(0.5) * cur_beta) / bpt
        cur_coeff = cur_alpha ** _f32(0.5) * bptp / bpt
        prev = float(orig_coeff) * x0 + float(cur_coeff) * sample

        variance = max(cur_beta * bptp / bpt, _f32(1e-20))
        if self.config.variance_type == "fixed_small_log":
            std = np.exp(_f32(0.5) * np.log(variance))
        else:
            std = variance ** _f32(0.5)
        if int(t) > 0:
            if noise is None:
                noise = torch.randn(sample.shape, generator=generator,
                                    device=sample.device, dtype=torch.float32)
            prev = prev + float(std) * noise
        return prev, x0

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  t: int) -> torch.Tensor:
        """Forward-noise clean samples to level t."""
        ac = self.alphas_cumprod[int(t)]
        return (float(ac ** _f32(0.5)) * original_samples
                + float((_f32(1.0) - ac) ** _f32(0.5)) * noise)
