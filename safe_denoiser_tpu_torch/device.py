"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a
GPU and without an explicit CPU request they raise: there is no silent CPU
carry-on.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); otherwise the
    device asked for, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


@contextlib.contextmanager
def ieee_f32():
    """f32 convolutions and matrix products without TF32 inside the block
    (cuDNN's switch defaults to TF32 on), as the JAX package's evaluators
    compute; both switches are restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
