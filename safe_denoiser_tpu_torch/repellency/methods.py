"""Repellency ("empirical negative denoiser") methods.

Counterpart of ``safe_denoiser_tpu/repellency/methods.py``:
``RepellencyConfig``, ``apply_repellency`` (kernel_fast / kernel /
euclidean / sparse / random_noise) and the host-side processors that hold
the projected negative bank, behind the registry and factory
(``get_repellency_method``): ``kernel_fast`` (the paper's method, beta
calibrated from a forward-noised bank), ``kernel``, ``euclidean``,
``random_noise``, ``sparse`` (SPELL, radius calibrated the same way) and,
registered by ``repellency/lsh.py``, ``lsh``. The bank caches are
``torch.save`` files, which the JAX package's ``io.load_pt`` reads and
whose writes ``torch.load`` reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from ..device import resolve_device
from ..ops.repellency_kernels import (
    _pairwise_dist,
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


def get_repellency_method(name: str, ref_data, embed_fn, forward_fn=None,
                          num_timesteps: int = 50, max_idx=None,
                          beta_min=None, beta_max=None, **kwargs
                          ) -> "RepellencyProcessor":
    """Factory with the JAX package's (and the reference's) signature."""
    if __CONDITIONING_METHOD__.get(name) is None:
        raise NameError(f"Name {name} is not defined! (one of "
                        f"{sorted(__CONDITIONING_METHOD__)})")
    return __CONDITIONING_METHOD__[name](
        ref_data=ref_data, embed_fn=embed_fn, forward_fn=forward_fn,
        num_timesteps=num_timesteps, max_idx=max_idx, beta_min=beta_min,
        beta_max=beta_max, **kwargs)


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


def apply_repellency(x0: torch.Tensor, refs, cfg: RepellencyConfig,
                     generator: torch.Generator | None = None, bank=None):
    """Repellency update on x0 [N, C, H, W] against the bank refs
    [M, C, H, W]. Returns (x0_new [N, C, H, W], is_negation [N] bool); for
    beta-gated methods the caller uses x0_new only where is_negation.
    ``bank``: a ``parallel.ShardedBank``, whose ``score`` / ``sparse_force``
    replace the kernels; refs is then the list of its shards
    (``parallel.shard_bank``, pad rows included) or a whole bank."""
    n, c, h, w = x0.shape
    d = c * h * w
    x_in = _channel_normalize(x0) if cfg.normalize_x else x0
    x_flat = x_in.reshape(n, d).float().contiguous()

    def flat(r):
        return r.reshape(r.shape[0], d).float().contiguous()

    refs_flat = ([flat(r) for r in refs] if isinstance(refs, (list, tuple))
                 else flat(refs))

    if cfg.method in ("kernel_fast", "kernel", "euclidean"):
        score_fn = bank.score if bank is not None else rbf_negative_score
        score, beta = score_fn(x_flat, refs_flat, cfg.sigma, cfg.epsilon)
        x0_new = x0 - cfg.scale * score.reshape(n, c, h, w)
        if cfg.use_beta_gate:
            is_neg = beta > (cfg.beta_threshold - cfg.beta_threshold_margin)
        else:
            is_neg = torch.ones((n,), dtype=torch.bool, device=x0.device)
        return x0_new, is_neg

    if cfg.method == "sparse":
        force_fn = (bank.sparse_force if bank is not None
                    else sparse_repellency_force)
        force, c_sum = force_fn(x_flat, refs_flat, cfg.radius)
        return x0 + cfg.scale * force.reshape(n, c, h, w), c_sum > 0.0

    if cfg.method == "random_noise":
        noise = torch.randn((n, d), generator=generator, device=x0.device,
                            dtype=torch.float32)
        return (x0 - cfg.scale * noise.reshape(n, c, h, w),
                torch.ones((n,), dtype=torch.bool, device=x0.device))

    raise NotImplementedError(f"method {cfg.method}")


class RepellencyProcessor:
    """Holds the projected negative bank and the thresholds; the pipeline
    reads ``config()`` and ``get_proj_ref()``, and ``conditioning`` applies
    the method to one x0 outside a sampling loop."""

    method_name = "base"

    def __init__(self, ref_data, embed_fn: Callable, forward_fn=None,
                 num_timesteps: int = 50, max_idx=None, beta_min=None,
                 beta_max=None, n_embed: int = 16, **kwargs):
        self.ref_data = ref_data
        self.embed_fn = embed_fn
        self.forward_fn = forward_fn
        self.num_timesteps = num_timesteps
        self.n_embed = n_embed

        self.sigma = kwargs.get("sigma", 1.0)
        self.scale = kwargs.get("scale", 1.0)
        self.epsilon = kwargs.get("epsilon", 1e-8)
        self.quantile = kwargs.get("quantile", 0.0)
        self.beta_threshold = kwargs.get("beta_threshold", False)
        self.beta_threshold_margin = kwargs.get("beta_threshold_margin", 0.0)
        self.normalize_x = kwargs.get("normalize_x", False)

        self.proj_ref_path = kwargs.get("proj_ref_path", None)
        self.proj_beta_ref_path = kwargs.get("proj_noisy_ref_path_for_beta",
                                             None)
        self.cache_proj_ref = kwargs.get("cache_proj_ref", False)
        self.cache_proj_beta_ref = kwargs.get("cache_noisy_ref_path_for_beta",
                                              False)
        # where an imported cache or euclidean's raw bank goes: cuda
        # unless the caller asks for another device (the runners pass the
        # pipeline's), so a cached bank is calibrated and read there
        self.device = resolve_device(kwargs.get("device"))

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
        """A bank cache (a tensor, or the noisy-bank dict {t: tensor}) on
        ``device``."""
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict):   # noisy-beta cache {t -> tensor}
            return {int(k): torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device)
                    for k, v in obj.items()}
        return torch.as_tensor(obj, dtype=torch.float32, device=self.device)

    def get_proj_ref(self) -> torch.Tensor:
        return self.proj_refs

    # -- beta / radius calibration -----------------------------------------
    def set_noisy_proj_ref(self, scheduler, num_timesteps=None,
                           seed: int = 42) -> dict:
        """Forward-noise the bank at every inference timestep ({t: refs at
        level t}); the noise is drawn from one ``torch.Generator`` seeded
        with ``seed`` on the bank's device, in timestep order."""
        n_steps = num_timesteps or self.num_timesteps or 50
        refs = self.proj_refs
        gen = torch.Generator(device=refs.device).manual_seed(seed)
        results = {}
        for t in scheduler.timesteps(n_steps):
            noise = torch.randn(refs.shape, generator=gen, device=refs.device,
                                dtype=torch.float32)
            results[int(t)] = scheduler.add_noise(refs.float(), noise, int(t))
        if self.proj_beta_ref_path:
            print("[Proj_Ref] Save the cached proj_beta_ref")
            os.makedirs(os.path.dirname(self.proj_beta_ref_path) or ".",
                        exist_ok=True)
            torch.save({k: v.detach().float().cpu()
                        for k, v in results.items()}, self.proj_beta_ref_path)
        return results

    def empirical_beta(self, noisy_proj_refs: dict, sigma: float,
                       quantile: float) -> dict:
        """Per-timestep quantile of the kernel density beta of the noisy
        bank against the bank."""
        refs_flat = self.proj_refs.reshape(self.proj_refs.shape[0], -1)
        results = {}
        for t, latents in noisy_proj_refs.items():
            x_flat = latents.reshape(latents.shape[0], -1).to(
                refs_flat.device)
            dist = _pairwise_dist(x_flat, refs_flat)
            beta = torch.exp(-dist / (2.0 * sigma ** 2)).sum(-1) \
                + self.epsilon
            q = float(torch.quantile(beta, quantile))
            print(f"Top {100 * (1 - quantile):.1f} % of radius at t={t}: "
                  f"{q:.3f}")
            results[t] = q
        return results

    def empirical_radius(self, noisy_proj_refs: dict, quantile: float
                         ) -> dict:
        """Per-timestep quantile of noisy-bank to bank distances."""
        refs_flat = self.proj_refs.reshape(self.proj_refs.shape[0], -1)
        results = {}
        for t, latents in noisy_proj_refs.items():
            x_flat = latents.reshape(latents.shape[0], -1).to(
                refs_flat.device)
            dist = _pairwise_dist(x_flat, refs_flat).reshape(-1)
            q = float(torch.quantile(dist, quantile))
            print(f"Top {100 * (1 - quantile):.1f} % of beta at t={t}: "
                  f"{q:.3f}")
            results[t] = q
        return results

    def _resolve_noisy_refs(self, scheduler) -> dict:
        if self.cache_proj_beta_ref:
            return self.import_proj_ref(self.proj_beta_ref_path)
        if scheduler is None:
            raise ValueError("a scheduler is needed to compute the beta "
                             "reference")
        return self.set_noisy_proj_ref(scheduler, self.num_timesteps)

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

    def conditioning(self, x_0_hat, **kwargs) -> dict:
        """The method on x0 [N, C, H, W] against the bank, on x0's device.
        ``beta_threshold=True`` applies the beta gate; ``generator=`` feeds
        random_noise (default: a generator seeded 0 on x0's device, as the
        JAX package's default key). Returns {"x_0_hat", "is_negation" (any
        sample), "mean_x_0_hat": None}."""
        x = torch.as_tensor(x_0_hat)
        cfg = dataclasses.replace(
            self.config(),
            use_beta_gate=bool(kwargs.get("beta_threshold", False)))
        gen = kwargs.get("generator")
        if gen is None:
            gen = torch.Generator(device=x.device).manual_seed(0)
        x0_new, is_neg = apply_repellency(
            x, self.get_proj_ref().to(x.device), cfg, generator=gen)
        return {"x_0_hat": x0_new, "is_negation": bool(is_neg.any()),
                "mean_x_0_hat": None}


@register_conditioning_method(name="kernel_fast")
class KernelFastRepellency(RepellencyProcessor):
    """The paper's main method. A non-positive or boolean beta_threshold
    asks for calibration: with a scheduler or a noisy-bank cache the
    threshold becomes ``empirical_beta`` at the last (t -> 0) timestep;
    without either the gate is disabled (threshold -1), as in the JAX
    package."""

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
            noisy = self._resolve_noisy_refs(kwargs.get("scheduler"))
            betas = self.empirical_beta(noisy, self.sigma, self.quantile)
            self.beta_threshold = betas[list(betas.keys())[-1]]
        elif needs_calibration:
            self.beta_threshold = -1.0


@register_conditioning_method(name="kernel")
class KernelRepellency(RepellencyProcessor):
    """The older formulation: x and the raw bank ``ref_data`` both go
    through ``project`` on every call for the distances, and the numerator
    weights the raw ``ref_data`` rows (which must be shaped like x0).
    Plain PyTorch: the fused score takes one bank for both."""

    method_name = "kernel"

    def conditioning(self, x_0_hat, **kwargs) -> dict:
        x = torch.as_tensor(x_0_hat).float()
        xf = self.project(x).reshape(x.shape[0], -1).to(x.device)
        rf = self.project(self.ref_data).reshape(len(self.ref_data), -1)
        rf = rf.to(x.device)
        w = torch.exp(-_pairwise_dist(xf, rf) / (2.0 * float(self.sigma) ** 2))
        raw = torch.as_tensor(self.ref_data, dtype=torch.float32,
                              device=x.device).reshape(rf.shape[0], -1)
        beta = w.sum(-1) + float(self.epsilon)
        score = (w @ raw) / beta[:, None]
        return {"x_0_hat": x - float(self.scale) * score.reshape(x.shape),
                "is_negation": True, "mean_x_0_hat": None}


@register_conditioning_method(name="euclidean")
class EuclideanRepellency(RepellencyProcessor):
    """kernel_fast's score against the raw ``ref_data``: no projection and
    no channel normalization of the bank."""

    method_name = "euclidean"

    def __init__(self, **kwargs):
        kwargs.setdefault("cache_proj_ref", False)
        super().__init__(**kwargs)

    def set_proj_ref(self) -> torch.Tensor:
        return torch.as_tensor(self.ref_data, dtype=torch.float32,
                               device=self.device)


@register_conditioning_method(name="random_noise")
class RandomNoiseRepellency(RepellencyProcessor):
    """Ablation: subtract scaled Gaussian noise, drawn from the caller's
    ``generator=``, instead of the score. The sampling loops refuse it
    (they pass no generator)."""

    method_name = "random_noise"


@register_conditioning_method(name="sparse")
class SparseRepellency(RepellencyProcessor):
    """SPELL's truncated repulsion. A non-positive ``radius`` asks for
    calibration: the ``quantile`` of the noisy-bank to bank distances at
    the last (t -> 0) timestep, the noisy bank from its cache or forward-
    noised through ``scheduler``."""

    method_name = "sparse"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.radius = kwargs.get("radius", -1.0)
        if self.radius <= 0:
            noisy = self._resolve_noisy_refs(kwargs.get("scheduler"))
            radii = self.empirical_radius(noisy, self.quantile)
            self.radius = radii[list(radii.keys())[-1]]
