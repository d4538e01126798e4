"""Repellency ("empirical negative denoiser") methods.

Counterpart of ``safe_denoiser_tpu/repellency/methods.py``:
``RepellencyConfig``, ``apply_repellency`` (kernel_fast / kernel /
euclidean / sparse / random_noise) and the host-side processor that holds
the projected negative bank, with the ``kernel_fast`` processor. The bank
cache is a ``torch.save`` file. The beta calibration from noisy banks
(``empirical_beta``) is not ported yet: a processor that would need it
raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from ..ops.repellency_kernels import (
    rbf_negative_score,
    sparse_repellency_force,
)

__CONDITIONING_METHOD__: dict[str, type] = {}


def register_conditioning_method(name: str):
    def wrapper(cls):
        if __CONDITIONING_METHOD__.get(name) is not None:
            raise NameError(f"Name {name} is already registered!")
        __CONDITIONING_METHOD__[name] = cls
        return cls
    return wrapper


def get_repellency_method(name: str, ref_data, embed_fn, **kwargs
                          ) -> "RepellencyProcessor":
    if __CONDITIONING_METHOD__.get(name) is None:
        raise NameError(f"Name {name} is not defined!")
    return __CONDITIONING_METHOD__[name](ref_data=ref_data,
                                         embed_fn=embed_fn, **kwargs)


@dataclasses.dataclass(frozen=True)
class RepellencyConfig:
    """Repellency parameters of one sampling run."""

    method: str = "kernel_fast"
    sigma: float = 1.0
    scale: float = 1.0
    epsilon: float = 1e-8
    beta_threshold: float = -1.0           # resolved (post-calibration) value
    beta_threshold_margin: float = 0.0
    radius: float = -1.0                   # sparse only
    normalize_x: bool = False              # SD3 variants channel-normalize x
    use_beta_gate: bool = True


def _channel_normalize(x: torch.Tensor) -> torch.Tensor:
    """L2-normalize over the channel axis (dim 1 of NCHW)."""
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def apply_repellency(x0: torch.Tensor, refs: torch.Tensor,
                     cfg: RepellencyConfig,
                     generator: torch.Generator | None = None):
    """Repellency update on x0 [N, C, H, W] against the bank refs
    [M, C, H, W]. Returns (x0_new [N, C, H, W], is_negation [N] bool); for
    beta-gated methods the caller uses x0_new only where is_negation."""
    n, c, h, w = x0.shape
    d = c * h * w
    x_in = _channel_normalize(x0) if cfg.normalize_x else x0
    x_flat = x_in.reshape(n, d).float().contiguous()
    refs_flat = refs.reshape(refs.shape[0], d).float().contiguous()

    if cfg.method in ("kernel_fast", "kernel", "euclidean"):
        score, beta = rbf_negative_score(x_flat, refs_flat, cfg.sigma,
                                         cfg.epsilon)
        x0_new = x0 - cfg.scale * score.reshape(n, c, h, w)
        if cfg.use_beta_gate:
            is_neg = beta > (cfg.beta_threshold - cfg.beta_threshold_margin)
        else:
            is_neg = torch.ones((n,), dtype=torch.bool, device=x0.device)
        return x0_new, is_neg

    if cfg.method == "sparse":
        force, c_sum = sparse_repellency_force(x_flat, refs_flat, cfg.radius)
        return x0 + cfg.scale * force.reshape(n, c, h, w), c_sum > 0.0

    if cfg.method == "random_noise":
        noise = torch.randn((n, d), generator=generator, device=x0.device,
                            dtype=torch.float32)
        return (x0 - cfg.scale * noise.reshape(n, c, h, w),
                torch.ones((n,), dtype=torch.bool, device=x0.device))

    raise NotImplementedError(f"method {cfg.method}")


class RepellencyProcessor:
    """Holds the projected negative bank and the thresholds; the pipeline
    reads ``config()`` and ``get_proj_ref()``."""

    method_name = "base"

    def __init__(self, ref_data, embed_fn: Callable, n_embed: int = 16,
                 **kwargs):
        self.ref_data = ref_data
        self.embed_fn = embed_fn
        self.n_embed = n_embed

        self.sigma = kwargs.get("sigma", 1.0)
        self.scale = kwargs.get("scale", 1.0)
        self.epsilon = kwargs.get("epsilon", 1e-8)
        self.beta_threshold = kwargs.get("beta_threshold", False)
        self.beta_threshold_margin = kwargs.get("beta_threshold_margin", 0.0)
        self.normalize_x = kwargs.get("normalize_x", False)

        self.proj_ref_path = kwargs.get("proj_ref_path", None)
        self.cache_proj_ref = kwargs.get("cache_proj_ref", False)
        self.cache_proj_beta_ref = kwargs.get("cache_noisy_ref_path_for_beta",
                                              False)

        if self.cache_proj_ref:
            self.proj_refs = self.import_proj_ref(self.proj_ref_path)
        else:
            self.proj_refs = self.set_proj_ref()

    def project(self, data) -> torch.Tensor:
        """Embed in chunks of ``n_embed`` and channel-normalize."""
        chunks = [self.embed_fn(data[i:i + self.n_embed])
                  for i in range(0, len(data), self.n_embed)]
        return _channel_normalize(torch.cat(chunks, dim=0))

    def set_proj_ref(self) -> torch.Tensor:
        result = self.project(self.ref_data)
        if self.proj_ref_path:
            os.makedirs(os.path.dirname(self.proj_ref_path) or ".",
                        exist_ok=True)
            torch.save(result.detach().float().cpu(), self.proj_ref_path)
        return result

    def import_proj_ref(self, path: str):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict):   # noisy-beta cache {t -> tensor}
            return {int(k): torch.as_tensor(v, dtype=torch.float32)
                    for k, v in obj.items()}
        return torch.as_tensor(obj, dtype=torch.float32)

    def get_proj_ref(self) -> torch.Tensor:
        return self.proj_refs

    def config(self) -> RepellencyConfig:
        return RepellencyConfig(
            method=self.method_name,
            sigma=float(self.sigma),
            scale=float(self.scale),
            epsilon=float(self.epsilon),
            beta_threshold=float(self.beta_threshold)
            if not isinstance(self.beta_threshold, bool) else -1.0,
            beta_threshold_margin=float(self.beta_threshold_margin),
            radius=float(getattr(self, "radius", -1.0)),
            normalize_x=bool(self.normalize_x),
            use_beta_gate=True,
        )


@register_conditioning_method(name="kernel_fast")
class KernelFastRepellency(RepellencyProcessor):
    """The paper's main method. A non-positive or boolean beta_threshold
    asks for calibration from a noisy bank, which is not ported yet: with
    a scheduler or a noisy-bank cache given that raises; without one the
    gate is disabled (threshold -1), as in the JAX package."""

    method_name = "kernel_fast"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.beta_threshold = kwargs.get("beta_threshold", -1.0)
        needs_calibration = (isinstance(self.beta_threshold, bool)
                             or not isinstance(self.beta_threshold,
                                               (int, float))
                             or self.beta_threshold <= 0)
        has_noisy_source = (self.cache_proj_beta_ref
                            or kwargs.get("scheduler") is not None)
        if needs_calibration and has_noisy_source:
            raise NotImplementedError(
                "beta calibration from a noisy bank (empirical_beta) is not "
                "ported yet; pass a positive beta_threshold")
        if needs_calibration:
            self.beta_threshold = -1.0
