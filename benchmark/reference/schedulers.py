"""The samplers' schedules as diffusers defines them, in float64: DDPM and
DDIM (scaled-linear betas, 'leading' spacing with ``steps_offset``) and
SD3's flow-match Euler (shifted sigmas).

Config keys are those of ``scheduler/scheduler_config.json``.
"""

from __future__ import annotations

import numpy as np


class DDPM:
    """``kind``: "ddpm" (fixed_small variance, noise added while t > 0) or
    "ddim" (eta 0: deterministic; ``set_alpha_to_one`` False)."""

    def __init__(self, cfg: dict, kind: str, steps: int):
        n = cfg["num_train_timesteps"]
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5,
                            n, dtype=np.float64) ** 2
        self.ac = np.cumprod(1.0 - betas)
        self.kind, self.steps, self.ratio = kind, steps, n // steps
        self.timesteps = (np.arange(steps) * self.ratio)[::-1].astype(
            np.int64) + cfg["steps_offset"]

    def _prev(self, t: int) -> float:
        prev = t - self.ratio
        if prev >= 0:
            return float(self.ac[prev])
        return 1.0 if self.kind == "ddpm" else float(self.ac[0])

    def x0(self, eps, t: int, x):
        a = float(self.ac[t])
        return (x - (1 - a) ** 0.5 * eps) / a ** 0.5

    def add_noise(self, x0, noise, t: int):
        a = float(self.ac[t])
        return a ** 0.5 * x0 + (1 - a) ** 0.5 * noise

    def step(self, eps, t: int, x, noise):
        a, ap = float(self.ac[t]), self._prev(t)
        x0 = self.x0(eps, t, x)
        if self.kind == "ddim":
            return ap ** 0.5 * x0 + (1 - ap) ** 0.5 * eps
        alpha, b, bp = a / ap, 1 - a, 1 - ap
        mean = (ap ** 0.5 * (1 - alpha) / b) * x0 + (alpha ** 0.5 * bp / b) * x
        if t > 0:
            mean = mean + (max((1 - alpha) * bp / b, 1e-20) ** 0.5) * noise
        return mean


def flow_match(cfg: dict, steps: int):
    """(timesteps [steps], sigmas [steps + 1] ending in 0) of diffusers'
    ``FlowMatchEulerDiscreteScheduler.set_timesteps``."""
    n, s = cfg["num_train_timesteps"], cfg["shift"]

    def shift(x):
        return s * x / (1 + (s - 1) * x)

    sigma_max = shift(1.0)
    sigma_min = shift(1.0 / n)
    ts = np.linspace(sigma_max * n, sigma_min * n, steps, dtype=np.float64)
    sigmas = shift(ts / n)
    return sigmas * n, np.concatenate([sigmas, [0.0]])
