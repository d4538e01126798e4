"""Autograd at the kernel wrappers.

A kernel writes into a fresh tensor through ctypes or Triton, so its
output has no ``grad_fn``: called under autograd, it would cut the graph
and every gradient through it would silently be missing. Three kernels
have a backward of their own, each an ``torch.autograd.Function`` beside
its forward (B1 ``ops/attention.py``, B5 ``ops/group_norm.py``, B3
``ops/conv3x3.py``), and ``adaln``'s Function (``ops/adaln.py``)
differentiates its plain version; every other CUDA wrapper first calls
``check_no_grad`` and raises instead.
"""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors``: grad mode is on
    and one of them (``None`` skipped) requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_no_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` where ``needs_grad(*tensors)``: ``kernel``
    has no backward yet, and its output would carry no gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel} has no backward yet: its output would carry no "
            "gradient. Call it under torch.no_grad() or on inputs that do "
            "not require grad")


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a plain version computes in: f64 for f64 inputs (so that
    ``torch.autograd.gradcheck`` can hold the Functions), else f32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32
