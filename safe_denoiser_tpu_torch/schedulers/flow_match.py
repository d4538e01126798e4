"""FlowMatchEuler scheduler for SD3 and FLUX (diffusers semantics).

Counterpart of ``safe_denoiser_tpu/schedulers/flow_match.py``. The tables
are computed on the host in float64 numpy and returned as float32, the
same arithmetic as the JAX package's; the sampling loop takes each sigma
as a host scalar.

SD3 shifts its sigmas by the fixed ``shift``. FLUX's configuration sets
``use_dynamic_shifting`` (``FlowMatchDynamicConfig``; the JAX package has
no FLUX): sigmas
``linspace(1, 1/N, N)`` (``FluxPipeline``'s), each moved by the exponential
time shift ``e^mu / (e^mu + 1/sigma - 1)`` with ``mu`` interpolated
linearly in the image's token count between (``base_image_seq_len``,
``base_shift``) and (``max_image_seq_len``, ``max_shift``)
(``calculate_shift``), as diffusers' ``set_timesteps(sigmas=, mu=)``.
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


@dataclass(frozen=True)
class FlowMatchDynamicConfig(FlowMatchEulerConfig):
    """A configuration with ``use_dynamic_shifting`` (FLUX): mu's line
    through (base_image_seq_len, base_shift), (max_image_seq_len,
    max_shift)."""
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096


def flow_match_config(raw: dict) -> FlowMatchEulerConfig:
    """The config of a ``scheduler_config.json``'s fields: a
    ``FlowMatchDynamicConfig`` where it sets ``use_dynamic_shifting``, else
    a ``FlowMatchEulerConfig``; fields the config has not are ignored."""
    cls = (FlowMatchDynamicConfig if raw.get("use_dynamic_shifting")
           else FlowMatchEulerConfig)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})


def flow_match_config_from_checkpoint(scheduler_dir: str
                                      ) -> FlowMatchEulerConfig:
    """The checkpoint's ``scheduler_config.json`` as ``flow_match_config``
    reads it (SD3-medium's defaults where there is none)."""
    path = os.path.join(scheduler_dir, "scheduler_config.json")
    if not os.path.exists(path):
        return FlowMatchEulerConfig()
    with open(path) as f:
        return flow_match_config(json.load(f))


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

    def mu(self, image_seq_len: int) -> float:
        """The dynamic shift's mu for an image of ``image_seq_len`` tokens:
        diffusers' ``calculate_shift``, linear through (base_image_seq_len,
        base_shift) and (max_image_seq_len, max_shift)."""
        c = self.config
        m = (c.max_shift - c.base_shift) / (c.max_image_seq_len
                                            - c.base_image_seq_len)
        return image_seq_len * m + (c.base_shift - m * c.base_image_seq_len)

    def timesteps_and_sigmas(self, num_inference_steps: int,
                             image_seq_len: int | None = None):
        """(timesteps [n], sigmas [n+1] ending in 0) as float32, as
        diffusers' ``set_timesteps``: without dynamic shifting a linspace
        between the shifted sigma_max/min mapped to timesteps, shifted
        again (``image_seq_len`` unused); with it, FLUX's sigmas under the
        exponential time shift at ``mu(image_seq_len)``."""
        n_train = self.config.num_train_timesteps
        if isinstance(self.config, FlowMatchDynamicConfig):
            if image_seq_len is None:
                raise ValueError("dynamic shifting needs the image's token "
                                 "count (image_seq_len)")
            e = np.exp(self.mu(image_seq_len))
            sigmas = np.linspace(1.0, 1.0 / num_inference_steps,
                                 num_inference_steps, dtype=np.float64)
            sigmas = e / (e + (1.0 / sigmas - 1.0))
        else:
            ts = np.linspace(self.sigma_max * n_train,
                             self.sigma_min * n_train, num_inference_steps,
                             dtype=np.float64)
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
