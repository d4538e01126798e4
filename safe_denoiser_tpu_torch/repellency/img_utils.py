"""Image-domain utilities of the reference's repellency package.

Counterpart of ``safe_denoiser_tpu/repellency/img_utils.py``, with its
signatures: the centred orthonormal 2-D FFT pair (``fft2c``/``ifft2c``),
``dynamic_thresholding`` (Imagen's per-sample percentile clamp of x0),
``gaussian_blur_kernel``/``apply_blur`` (a depthwise blur of NHWC images)
and ``mask_generator`` (box or random inpainting masks from a numpy seed).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def fft2c(x: torch.Tensor) -> torch.Tensor:
    """Centred orthonormal 2-D FFT over the last two axes."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.fftn(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


def ifft2c(x: torch.Tensor) -> torch.Tensor:
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.ifftn(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


def dynamic_thresholding(x0: torch.Tensor, percentile: float = 0.995,
                         floor: float = 1.0) -> torch.Tensor:
    """Per sample: s = max(the ``percentile`` quantile of |x0| (linear),
    ``floor``); x0 clipped to [-s, s] and divided by s."""
    n = x0.shape[0]
    s = torch.quantile(x0.reshape(n, -1).abs(), percentile, dim=-1)
    s = torch.clamp(s, min=floor)[:, None, None, None]
    return torch.maximum(torch.minimum(x0, s), -s) / s


def gaussian_blur_kernel(size: int, sigma: float) -> np.ndarray:
    """[size, size] normalized Gaussian kernel (f32)."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def apply_blur(images: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Depthwise 2-D convolution of NHWC images with one kernel, SAME
    padding (for an even kernel size the extra zero row and column go
    after, as XLA pads)."""
    c = images.shape[-1]
    kh, kw = kernel.shape
    k = torch.as_tensor(kernel, dtype=images.dtype, device=images.device)
    x = images.permute(0, 3, 1, 2)
    x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    y = F.conv2d(x, k.expand(c, 1, kh, kw), groups=c)
    return y.permute(0, 2, 3, 1)


def mask_generator(shape: tuple[int, int], mask_type: str = "box",
                   box_size: int = 128, prob: float = 0.5,
                   seed: int = 0) -> np.ndarray:
    """[H, W] binary mask: 1 = keep, 0 = masked."""
    h, w = shape
    rng = np.random.RandomState(seed)
    mask = np.ones((h, w), dtype=np.float32)
    if mask_type == "box":
        top = rng.randint(0, max(h - box_size, 1))
        left = rng.randint(0, max(w - box_size, 1))
        mask[top:top + box_size, left:left + box_size] = 0.0
    elif mask_type == "random":
        mask = (rng.rand(h, w) > prob).astype(np.float32)
    else:
        raise ValueError(f"unknown mask_type {mask_type}")
    return mask
