"""The MMDiT's modulated LayerNorm and gated residual in one pass over a
row (CUDA, ``csrc/adaln.cu``), its plain version, and the test of which
tensors the kernel takes. The MMDiT sends every such site here.

On [B, S, D] rows x of the token-major stream, with per-batch-row [B, D]
(or [1, D], read by every row) vectors scale, shift and gate (views of the
block's modulation chunks, read in place) and delta shaped as x, the kernel
has three modes, chosen by the arguments given:

| mode              | given                     | returns                   |
| ----------------- | ------------------------- | ------------------------- |
| norm              | scale, shift              | h = LN(x)*(1+scale)+shift |
| residual + norm   | gate, delta, scale, shift | (x' = x+gate*delta, h of x') |
| residual          | gate, delta               | x'                        |

LN has no affine (eps 1e-6, the MMDiT's). The kernel replaces no TPU
kernel: the JAX package leaves these sites to XLA, which fuses them, where
an eager composition (an f32 LayerNorm, then the modulation in the stream's
dtype) is about ten launches a norm site with an f32 round trip of the row.
It is bound by bytes: the
residual + norm mode at SD3-medium's [2, 4096, 1536] bf16 moves 100.7 MB,
30 us at 3.35 TB/s. Design notes in the source.

The numerics are ``adaln_ref``'s: f32 throughout, each output rounded to
x's dtype once (the eager composition rounds the norm, the modulation and
the residual's product separately), and the norm of x' taken as rounded.
Under autograd ``AdaLN`` runs the same forward and differentiates
``adaln_ref`` in its backward.
"""

from __future__ import annotations

import torch

from . import _build
from ._grad import acc_dtype, needs_grad

launches = 0   # kernel launches of adaln on CUDA tensors

MAX_D = 3072   # csrc/adaln.cu: 32 lanes x 8 values x NV_MAX vectors a row
EPS = 1e-6
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def _mode(scale, shift, gate, delta) -> int:
    """csrc/adaln.cu's mode of the arguments given: 0 norm, 1 residual +
    norm, 2 residual."""
    norm, res = scale is not None, delta is not None
    if norm != (shift is not None) or res != (gate is not None) or not (
            norm or res):
        raise ValueError("adaln takes scale and shift, gate and delta, or "
                         "all four")
    return 1 if norm and res else (0 if norm else 2)


def adaln_ref(x: torch.Tensor, scale=None, shift=None, gate=None, delta=None,
              eps: float = EPS):
    """Plain version of the kernel, in its numerics: the residual x + gate *
    delta in f32 rounded to x's dtype once; the f32 mean of the row, then
    the mean of its centred squares; h = (x - mean) * rsqrt(var + eps) *
    (1 + scale) + shift in f32, rounded once. Returns h, (x', h) or x' as
    the module's table says (f64 in f64 for x of f64)."""
    mode = _mode(scale, shift, gate, delta)
    acc = acc_dtype(x)

    def col(v):
        return v.to(acc)[:, None]

    if mode != 0:
        x = (x.to(acc) + col(gate) * delta.to(acc)).to(x.dtype)
        if mode == 2:
            return x
    xf = x.to(acc)
    xc = xf - xf.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    h = (xc * torch.rsqrt(var + eps) * (1 + col(scale)) + col(shift)
         ).to(x.dtype)
    return h if mode == 0 else (x, h)


def _fits_layout(t: torch.Tensor) -> bool:
    """A contiguous last dimension, the other strides whole vectors of 8
    values (0 broadcasts) and a 16-byte aligned start."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def fits(x: torch.Tensor, scale=None, shift=None, gate=None,
         delta=None) -> bool:
    """Whether the kernel takes these tensors, on any device: x a [B, S, D]
    bf16, f16 or f32 tensor with D % 8 == 0 and D <= MAX_D, delta x's
    shape, scale, shift and gate [B, D] or [1, D], all of x's dtype and
    device and of ``_fits_layout``."""
    mods = [t for t in (scale, shift, gate) if t is not None]
    if x.dtype not in _DTYPES or x.dim() != 3:
        return False
    b, _, d = x.shape
    rest = mods + ([delta] if delta is not None else [])
    return (d % 8 == 0 and d <= MAX_D
            and (delta is None or delta.shape == x.shape)
            and all(t.dim() == 2 and t.shape[0] in (1, b) and t.shape[1] == d
                    for t in mods)
            and all(t.dtype == x.dtype and t.device == x.device
                    for t in rest)
            and all(_fits_layout(t) for t in (x, *rest)))


def _kernel_args(x, scale, shift, gate, delta, x_out, h_out) -> tuple:
    """``sdt_adaln``'s pointers and strides (in elements): x's and delta's
    (pointer, batch stride, row stride), gate's, scale's and shift's
    (pointer, batch stride), then the outputs' pointers. A missing tensor
    reads 0; so does the batch stride of a tensor with one batch row, which
    every row of x reads."""
    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def batch(t):
        return 0 if t is None or t.shape[0] == 1 else t.stride(0)

    return (ptr(x), batch(x), x.stride(1),
            ptr(delta), batch(delta), 0 if delta is None else delta.stride(1),
            ptr(gate), batch(gate), ptr(scale), batch(scale),
            ptr(shift), batch(shift), ptr(x_out), ptr(h_out))


def _adaln_cuda(x, scale, shift, gate, delta, eps):
    global launches
    mode = _mode(scale, shift, gate, delta)
    if not x.is_cuda or not fits(x, scale, shift, gate, delta):
        raise ValueError(
            f"adaln takes a bf16, f16 or f32 [B, S, D] x with D % 8 == 0 and "
            f"D <= {MAX_D}, delta of its shape and [B, D] or [1, D] "
            f"modulations of its dtype, on one GPU, each with a contiguous "
            f"last dimension, 16-byte strides and start; got x {x.dtype} "
            f"{tuple(x.shape)} strides {x.stride()} on {x.device}")
    b, s, d = x.shape
    x_out = torch.empty_like(x, memory_format=torch.contiguous_format) \
        if mode != 0 else None
    h_out = torch.empty_like(x, memory_format=torch.contiguous_format) \
        if mode != 2 else None

    err = _build.library("adaln").sdt_adaln(
        *_kernel_args(x, scale, shift, gate, delta, x_out, h_out),
        _DTYPES[x.dtype], mode, b, s, d, float(eps),
        _build.stream_ptr(x.device))
    _build.check(err, "sdt_adaln")
    launches += 1
    return h_out if mode == 0 else (x_out if mode == 2 else (x_out, h_out))


def _adaln(x, scale, shift, gate, delta, eps):
    if _build.takes_plain(x):
        return adaln_ref(x, scale, shift, gate, delta, eps)
    return _adaln_cuda(x, scale, shift, gate, delta, eps)


class AdaLN(torch.autograd.Function):
    """The kernel with a backward: the forward is ``adaln``'s without
    autograd (the kernel on CUDA, counted the same, ``adaln_ref`` on the
    CPU); the backward recomputes ``adaln_ref`` on the saved inputs and
    differentiates it (plain PyTorch, on either device)."""

    @staticmethod
    def forward(ctx, x, scale, shift, gate, delta, eps):
        ctx.save_for_backward(x, scale, shift, gate, delta)
        ctx.eps = eps
        return _adaln(x, scale, shift, gate, delta, eps)

    @staticmethod
    def backward(ctx, *grads):
        ins = [None if t is None else t.detach().requires_grad_(want)
               for t, want in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        with torch.enable_grad():
            outs = adaln_ref(*ins, eps=ctx.eps)
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = iter(torch.autograd.grad(outs, wanted, grads))
        return (*(next(got) if t is not None and t.requires_grad else None
                  for t in ins), None)


def adaln(x: torch.Tensor, scale=None, shift=None, gate=None, delta=None,
          eps: float = EPS):
    """The modulated LayerNorm and/or gated residual of the module's table.
    A CUDA tensor launches the kernel or raises (``fits`` says which it
    takes); a CPU tensor takes the plain version; under autograd both go
    through ``AdaLN``."""
    if needs_grad(x, scale, shift, gate, delta):
        return AdaLN.apply(x, scale, shift, gate, delta, eps)
    return _adaln(x, scale, shift, gate, delta, eps)
