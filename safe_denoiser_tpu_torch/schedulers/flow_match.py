"""FlowMatchEuler scheduler for SD3 (diffusers semantics).

Counterpart of ``safe_denoiser_tpu/schedulers/flow_match.py``. The tables
are computed on the host in float64 numpy and returned as float32, the
same arithmetic as the JAX package's; the sampling loop takes each sigma
as a host scalar.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FlowMatchEulerConfig:
    num_train_timesteps: int = 1000
    shift: float = 3.0


def flow_match_config_from_checkpoint(scheduler_dir: str
                                      ) -> FlowMatchEulerConfig:
    """The checkpoint's ``scheduler_config.json`` fields that the config
    has (SD3-medium's defaults where there is none)."""
    path = os.path.join(scheduler_dir, "scheduler_config.json")
    if not os.path.exists(path):
        return FlowMatchEulerConfig()
    with open(path) as f:
        raw = json.load(f)
    names = {f.name for f in dataclasses.fields(FlowMatchEulerConfig)}
    return FlowMatchEulerConfig(**{k: v for k, v in raw.items()
                                   if k in names})


class FlowMatchEulerScheduler:
    def __init__(self, config: FlowMatchEulerConfig = FlowMatchEulerConfig()):
        self.config = config
        n = config.num_train_timesteps
        ts = np.linspace(1, n, n, dtype=np.float64)[::-1]
        sigmas = self._shift(ts / n)
        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])

    def _shift(self, sigmas):
        s = self.config.shift
        return s * sigmas / (1 + (s - 1) * sigmas)

    def timesteps_and_sigmas(self, num_inference_steps: int):
        """(timesteps [n], sigmas [n+1] ending in 0) as float32, as
        diffusers' ``set_timesteps``: a linspace between the shifted
        sigma_max/min mapped to timesteps, shifted again."""
        n_train = self.config.num_train_timesteps
        ts = np.linspace(self.sigma_max * n_train, self.sigma_min * n_train,
                         num_inference_steps, dtype=np.float64)
        sigmas = self._shift(ts / n_train)
        timesteps = (sigmas * n_train).astype(np.float32)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return timesteps, sigmas

    @staticmethod
    def step(model_output, sigma, sigma_next, sample):
        """Euler step: ``sample + (sigma_next - sigma) * model_output``."""
        return sample + (sigma_next - sigma) * model_output

    @staticmethod
    def scale_noise(sample, sigma, noise):
        """Forward process: ``(1 - sigma) * x0 + sigma * noise``."""
        return (1.0 - sigma) * sample + sigma * noise
