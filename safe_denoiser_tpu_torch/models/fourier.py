"""FreeU and the SafeGuard Fourier filters on skip connections (NHWC).

Counterpart of ``safe_denoiser_tpu/models/fourier.py``, on ``torch.fft``.
The UNet applies them to its up path's skip features when it is given a
``FreeUConfig``. Batch layout, as in the JAX package (and the reference
it follows): the guidance batch is ``[uncond, cond, re-attention]`` and the
SafeGuard filters change batch row 1 using row 2 as the frequency
reference, so they assume one prompt per batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class FreeUConfig:
    b1: float = 1.2
    b2: float = 1.4
    s1: float = 0.9
    s2: float = 0.2
    # 'freeu': plain FreeU scaling; 'high' / 'low' / 'all': SafeGuard
    mode: str = "all"
    in_freeu: bool = False


def _fft2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fftn(x, dim=(1, 2)), dim=(1, 2))


def _ifft2(f: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftn(torch.fft.ifftshift(f, dim=(1, 2)),
                           dim=(1, 2)).real


def _low_box(h: int, w: int, threshold: int):
    crow, ccol = h // 2, w // 2
    return (slice(crow - threshold, crow + threshold),
            slice(ccol - threshold, ccol + threshold))


def fourier_filter(x: torch.Tensor, threshold: int,
                   scale: float) -> torch.Tensor:
    """Plain FreeU: the low-frequency box of [B, H, W, C] x scaled by
    ``scale``; f32 transforms, the output in x's dtype."""
    f = _fft2(x.float())
    rs, cs = _low_box(x.shape[1], x.shape[2], threshold)
    f[:, rs, cs, :] *= scale
    return _ifft2(f).to(x.dtype)


def safeguard_low_fourier_filter(x: torch.Tensor, threshold: int,
                                 scale: float) -> torch.Tensor:
    """SafeGuard low band on [B, H, W, C], B >= 3: in row 1's
    low-frequency box, keep row 1 where row 2's real part exceeds it,
    else set ``scale``."""
    f = _fft2(x.float())
    rs, cs = _low_box(x.shape[1], x.shape[2], threshold)
    low = f[:, rs, cs, :]
    keep = (low[2] - low[1]).real > 0.0
    f[1, rs, cs, :] = torch.where(keep, low[1],
                                  torch.full_like(low[1], scale))
    return _ifft2(f).to(x.dtype)


def safeguard_high_fourier_filter(x: torch.Tensor, threshold: int,
                                  scale: float,
                                  in_freeu: bool = False) -> torch.Tensor:
    """SafeGuard high band on [B, H, W, C], B >= 3: outside the low box,
    row 1 becomes ``scale`` where |Re row 2| > |Re row 1|; with
    ``in_freeu`` the whole batch's low box is then scaled by ``scale``."""
    f = _fft2(x.float())
    h, w = x.shape[1], x.shape[2]
    rs, cs = _low_box(h, w, threshold)
    high = torch.ones((h, w), dtype=torch.bool, device=x.device)
    high[rs, cs] = False
    hm = high[:, :, None]
    high_f = f * hm
    new1 = torch.where(high_f[2].real.abs() > high_f[1].real.abs(),
                       torch.full_like(f[1], scale), high_f[1])
    f[1] = torch.where(hm, new1, f[1])
    if in_freeu:
        f[:, rs, cs, :] *= scale
    return _ifft2(f).to(x.dtype)


def apply_skip_filter(res: torch.Tensor, cfg: Optional[FreeUConfig],
                      stage_scale: float) -> torch.Tensor:
    """The configured filter on one [B, H, W, C] skip connection, threshold
    1 (the reference's fixed value)."""
    if cfg is None:
        return res
    if cfg.mode == "freeu":
        return fourier_filter(res, 1, stage_scale)
    if cfg.mode == "high":
        return safeguard_high_fourier_filter(res, 1, stage_scale,
                                             cfg.in_freeu)
    if cfg.mode == "low":
        return safeguard_low_fourier_filter(res, 1, stage_scale)
    if cfg.mode == "all":
        res = safeguard_high_fourier_filter(res, 1, stage_scale,
                                            cfg.in_freeu)
        return safeguard_low_fourier_filter(res, 1, stage_scale)
    raise ValueError(f"unknown FreeU mode {cfg.mode}")
