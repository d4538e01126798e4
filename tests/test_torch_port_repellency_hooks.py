"""The sampling loops' repellency hooks refuse ``method="random_noise"`` in
both packages: their hooks pass no random source (JAX: no ``rng``; the
port: no ``generator``), so the method would otherwise draw from a global
stream and two runs on the same inputs would differ. ``apply_repellency``
with an explicit generator keeps the method
(``test_torch_port_sampler.py::test_random_noise_method_shape_and_gate``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.pipeline import sampler as j_sampler
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPMScheduler
from safe_denoiser_tpu_torch.pipeline import sampler as t_sampler
from safe_denoiser_tpu_torch.repellency import methods as t_methods
from safe_denoiser_tpu_torch.schedulers import (
    DDPMScheduler, FlowMatchEulerScheduler)

T = 901


def _inputs():
    rng = np.random.default_rng(61)
    x, eps, noise = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
                     for _ in range(3))
    refs = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    return x, eps, noise, refs


def test_sd_hooks_of_both_packages_refuse_random_noise():
    """x [2,4,8,8], a 3-row bank, scale 0.5, t = 901, DDPM: the JAX hook
    asserts (no rng), the port's hook raises before drawing any noise."""
    x, eps, noise, refs = _inputs()
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    with pytest.raises(AssertionError):
        j_sampler._repellency_hook(
            JDDPMScheduler(), nhwc(eps), T, nhwc(x), jnp.asarray(refs),
            j_methods.RepellencyConfig(method="random_noise", scale=0.5),
            jnp.asarray(True), nhwc(noise))
    state = torch.get_rng_state()
    with pytest.raises(ValueError, match="random_noise"):
        t_sampler._repellency_hook(
            DDPMScheduler(), torch.from_numpy(eps), T, torch.from_numpy(x),
            torch.from_numpy(refs),
            t_methods.RepellencyConfig(method="random_noise", scale=0.5),
            torch.from_numpy(noise))
    assert torch.equal(torch.get_rng_state(), state)


def test_sd3_repellency_step_refuses_random_noise():
    """The port's SD3 loop refuses the method at its first in-window
    step."""
    x, _, noise, refs = _inputs()
    calls = []

    def transformer(lat, t, ctx, pooled):
        calls.append(float(t[0]))
        return torch.zeros_like(lat)

    with pytest.raises(ValueError, match="random_noise"):
        t_sampler.sample_sd3(
            transformer, FlowMatchEulerScheduler(), torch.zeros(2, 2, 3, 8),
            torch.zeros(2, 2, 8), torch.from_numpy(x),
            lambda i, salt: torch.from_numpy(noise), 4,
            repellency=t_methods.RepellencyConfig(method="random_noise",
                                                  scale=0.5),
            refs=torch.from_numpy(refs))
    assert len(calls) == 1
