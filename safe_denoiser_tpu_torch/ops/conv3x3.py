"""Upsample-fused 3x3 conv: the CUDA kernel (``csrc/conv3x3_up.cu``) and its
plain PyTorch version.

Counterpart of ``safe_denoiser_tpu/ops/conv3x3.py::conv3x3_up`` and its
``supports_up`` gate, with the JAX package's NHWC layout at the public
function. The fused full-resolution conv (``_kernel``, ``conv3x3``) is not
ported yet.

conv3x3_SAME(nearest_2x(h)) splits into four output parities, each a 2x2
conv of the half-resolution input with pre-summed weights (``w_eff_up``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

launches = 0   # kernel launches of conv3x3_up on CUDA tensors

# tap groups of the 3x3 kernel per output parity: j=0/1 -> taps of dy
_GROUPS = {0: ((0,), (1, 2)), 1: ((0, 1), (2,))}


def w_eff_up(w_hwio: torch.Tensor) -> torch.Tensor:
    """[3, 3, Ci, Co] -> [2(py), 2(px), 2(j), 2(k), Ci, Co] pre-summed
    parity weights (counterpart of ``_w_eff_up``, summed in f32)."""
    w = w_hwio.float()
    rows = []
    for py in range(2):
        for px in range(2):
            for j in range(2):
                for k in range(2):
                    acc = 0
                    for dy in _GROUPS[py][j]:
                        for dx in _GROUPS[px][k]:
                            acc = acc + w[dy, dx]
                    rows.append(acc)
    return torch.stack(rows).reshape(2, 2, 2, 2, *w.shape[2:])


def _pick_tile_h2(h2: int, w2: int, co: int) -> int:
    budget = 1.25e6
    for th2 in (8, 4, 2, 1):
        if h2 % th2 == 0 and h2 >= th2 + 2 and th2 * w2 * co * 4 <= budget:
            return th2
    return 1


def supports_up(h_shape, ci: int, co: int) -> bool:
    """The JAX package's predicate for the upsample-fused kernel, kept
    unchanged so routing and launch counts match: the VAE decoder's three
    upsamples and the UNet's 640-channel one qualify."""
    b, h2, w2, _ = h_shape
    th2 = _pick_tile_h2(h2, w2, co)
    return (ci % 128 == 0 and co % 128 == 0 and w2 % 16 == 0
            and h2 % th2 == 0 and h2 >= th2 + 2
            and ci <= 1024 and co <= 1024)


def conv3x3_up_ref(h: torch.Tensor, w_oihw: torch.Tensor,
                   b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: nearest 2x upsample, then a SAME 3x3 conv with f32
    accumulation; NHWC [B, H2, W2, Ci] -> [B, 2*H2, 2*W2, Co] in h's dtype."""
    x = h.permute(0, 3, 1, 2).float()
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    out = F.conv2d(x, w_oihw.float(), None if b is None else b.float(),
                   padding=1)
    return out.permute(0, 2, 3, 1).to(h.dtype)


def kernel_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """diffusers [Co, Ci, 3, 3] -> the kernel's [4, Co, 4*Ci] bf16 layout:
    parity p = 2*py + px, K index (2*j + k)*Ci + ci."""
    co, ci = w_oihw.shape[:2]
    weff = w_eff_up(w_oihw.permute(2, 3, 1, 0))       # [2,2,2,2,Ci,Co]
    return (weff.reshape(4, 4, ci, co).permute(0, 3, 1, 2)
            .reshape(4, co, 4 * ci).to(torch.bfloat16).contiguous())


def pack_weights(w_oihw: torch.Tensor, b: torch.Tensor | None = None):
    """(kernel_weights(w_oihw), bias as f32 [Co]): what the kernel reads.
    A caller that reuses its weights packs them once (``packed=`` of
    ``conv3x3_up``)."""
    co = w_oihw.shape[0]
    bias = (torch.zeros(co, device=w_oihw.device) if b is None
            else b.detach().float().contiguous())
    return kernel_weights(w_oihw.detach()), bias


def _conv3x3_up_cuda(h, w_oihw, b, packed):
    global launches
    if not h.is_cuda or w_oihw.device != h.device or (
            b is not None and b.device != h.device):
        raise ValueError("h, the weight and the bias must lie on one GPU")
    if h.dtype != torch.bfloat16:
        raise ValueError(f"up-conv kernel takes bf16, got {h.dtype}")
    if h.dim() != 4 or not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError("h must be a contiguous, 16-byte aligned NHWC tensor")
    bsz, h2, w2, ci = h.shape
    co = w_oihw.shape[0]
    if tuple(w_oihw.shape) != (co, ci, 3, 3):
        raise ValueError(f"weight {tuple(w_oihw.shape)} does not match "
                         f"Ci={ci}")
    if ci % 32 or co % 64:
        raise ValueError(f"up-conv kernel needs Ci % 32 == 0 and "
                         f"Co % 64 == 0, got Ci={ci}, Co={co}")
    wt, bias = pack_weights(w_oihw, b) if packed is None else packed
    if not (wt.shape == (4, co, 4 * ci) and wt.dtype == torch.bfloat16
            and wt.is_contiguous() and wt.device == h.device
            and bias.shape == (co,) and bias.dtype == torch.float32
            and bias.device == h.device):
        raise ValueError("packed weights are not pack_weights(w, b) of this "
                         "weight on this GPU")
    out = torch.empty((bsz, 2 * h2, 2 * w2, co), dtype=h.dtype,
                      device=h.device)
    fn = _build.library("conv3x3_up").sdt_conv3x3_up_bf16
    err = fn(h.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
             bsz, h2, w2, ci, co, _build.stream_ptr(h.device))
    _build.check(err, "sdt_conv3x3_up_bf16")
    launches += 1
    return out


def conv3x3_up(h: torch.Tensor, w_oihw: torch.Tensor,
               b: torch.Tensor | None = None, packed=None) -> torch.Tensor:
    """conv3x3_SAME(nearest_2x(h), w) + b for NHWC half-res h
    [B, H2, W2, Ci]; weights in diffusers' [Co, Ci, 3, 3]. A CUDA tensor
    launches the kernel (bf16) or raises; a CPU tensor takes the plain
    version. ``packed``: ``pack_weights(w_oihw, b)``, computed once by a
    caller that reuses the weights; built per call when None."""
    if h.device.type == "cpu":
        return conv3x3_up_ref(h, w_oihw, b)
    return _conv3x3_up_cuda(h, w_oihw, b, packed)


def flops(b: int, h2: int, w2: int, ci: int, co: int) -> int:
    """Operations of one call: four parities of a K = 4*Ci product."""
    return 2 * b * h2 * w2 * co * 4 * ci * 4
