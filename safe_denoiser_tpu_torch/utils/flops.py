"""Analytic model-FLOP counting for MFU reporting.

Counterpart of ``safe_denoiser_tpu/utils/flops.py``. JAX counts the
``dot_general`` and ``conv_general_dilated`` FLOPs of a jaxpr traced on its
XLA reference paths; the port counts the same model FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` over the kernels' **plain**
versions (the CUDA kernels are ``ctypes`` launches the counter cannot
see), run on the ``meta`` device: shapes only, so full-width towers count
in seconds without compute. ``ops._build.plain_on_meta`` is the one context
in which the kernel wrappers take their plain versions for ``meta`` tensors
(a CUDA tensor still launches its kernel or raises); it is restored on
exit. The count is implementation-independent: tile padding and fusion do
not change it. ``mfu = (achieved model FLOP/s) / (peak FLOP/s)``.

Scope, as in the JAX package:
  * only matrix products and convolutions count (``aten.mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``convolution``, the attention calls and
    ``_int_mm``); elementwise work, softmax and norms do not;
  * the repellency bank kernel lies outside the model towers and is
    excluded (count the UNet, MMDiT, text encoders and VAE, not the bank);
  * int8 layers count their model FLOPs against the bf16 peak.
"""

from __future__ import annotations

import os

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# NVIDIA H100 SXM dense bf16 tensor-core peak, FLOP/s (data sheet)
H100_PEAK_BF16 = 989e12

if torch.ops.aten._int_mm.default not in \
        torch.utils.flop_counter.flop_registry:
    @register_flop_formula(torch.ops.aten._int_mm)
    def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
        """int8 [M, K] @ [K, N]: 2·M·N·K, as JAX counts an int8 dot."""
        m, k = a_shape
        return 2 * m * k * b_shape[1]


def _to_meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def model_flops(fn, *args, **kwargs) -> float:
    """Matrix-product + convolution FLOPs of one ``fn(*args, **kwargs)``
    call. Tensor arguments are moved to ``meta`` (build modules on it:
    ``with torch.device("meta"): Model(cfg)``); nothing is computed."""
    from ..ops._build import plain_on_meta

    args = [_to_meta(a) for a in args]
    kwargs = {k: _to_meta(v) for k, v in kwargs.items()}
    counter = FlopCounterMode(display=False)
    with plain_on_meta(), counter, torch.no_grad():
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(img_per_sec: float, flops_per_img: float,
        peak: float | None = None) -> float:
    peak = peak or float(os.environ.get("SDT_PEAK_FLOPS", H100_PEAK_BF16))
    return img_per_sec * flops_per_img / peak
