"""The two 3x3 conv kernels of the VAE, each beside its plain PyTorch
version, with the JAX package's NHWC layout at the public functions:

- ``conv3x3``: residual + conv3x3_SAME(act(x*a + b)) + bias, the resnet
  conv with the GroupNorm-affine+SiLU prologue and the residual epilogue
  fused in (``csrc/conv3x3.cu``; counterpart of
  ``safe_denoiser_tpu/ops/conv3x3.py::conv3x3`` and its ``supports``
  gate).
- ``conv3x3_up``: conv3x3_SAME(nearest_2x(h)) without the upsampled tensor
  (counterpart of ``conv3x3_up`` and ``supports_up``). It splits into four
  output parities, each a 2x2 conv of the half-resolution input with
  pre-summed weights (``w_eff_up``). ``form="planar"`` launches
  ``csrc/conv3x3_up.cu`` (the JAX package's ``_up_kernel_planar``),
  ``form="interleave"`` ``csrc/conv3x3_up_interleave.cu`` (its
  ``_up_kernel``: all four parities from one staged band); both compute
  the same function, with the same plain version and packed weights.

Weights arrive in diffusers' [Co, Ci, 3, 3] layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._grad import acc_dtype, check_no_grad, needs_grad

up_launches = 0      # kernel launches of conv3x3_up (planar) on CUDA tensors
interleave_launches = 0   # ... of conv3x3_up(form="interleave")
fused_launches = 0   # kernel launches of conv3x3 on CUDA tensors
bwd_dx_launches = 0  # calls of B3's backward for dh (B3b-dx)
bwd_dw_launches = 0  # calls of B3's backward for dW, db (B3b-dw)
UP_FORMS = ("planar", "interleave")

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
    accumulation (f64 for f64 h); NHWC [B, H2, W2, Ci] -> [B, 2*H2, 2*W2,
    Co] in h's dtype."""
    acc = acc_dtype(h)
    x = h.permute(0, 3, 1, 2).to(acc)
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    out = F.conv2d(x, w_oihw.to(acc), None if b is None else b.to(acc),
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


def _conv3x3_up_cuda(h, w_oihw, b, packed, form):
    global up_launches, interleave_launches
    check_no_grad(f"conv3x3_up ({'B3' if form == 'planar' else 'B7'}, "
                  f"form {form!r}) outside ConvUp", h, w_oihw, b)
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
    if wt.data_ptr() % 16 or bias.data_ptr() % 16 or not bias.is_contiguous():
        raise ValueError("the packed weights and bias must be contiguous and "
                         "16-byte aligned")
    out = torch.empty((bsz, 2 * h2, 2 * w2, co), dtype=h.dtype,
                      device=h.device)
    name = "conv3x3_up" if form == "planar" else "conv3x3_up_interleave"
    entry = f"sdt_{name}_bf16"
    err = getattr(_build.library(name), entry)(
        h.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), bsz,
        h2, w2, ci, co, _build.stream_ptr(h.device))
    _build.check(err, entry)
    if form == "planar":
        up_launches += 1
    else:
        interleave_launches += 1
    return out


def conv3x3_up(h: torch.Tensor, w_oihw: torch.Tensor,
               b: torch.Tensor | None = None, packed=None,
               form: str = "planar") -> torch.Tensor:
    """conv3x3_SAME(nearest_2x(h), w) + b for NHWC half-res h
    [B, H2, W2, Ci]; weights in diffusers' [Co, Ci, 3, 3]. A CUDA tensor
    launches the kernel of ``form`` (bf16; ``UP_FORMS``) or raises; a CPU
    tensor takes the plain version. ``packed``: ``pack_weights(w_oihw,
    b)``, computed once by a caller that reuses the weights; built per
    call when None."""
    if form not in UP_FORMS:
        raise ValueError(f"form must be one of {UP_FORMS}, got {form!r}")
    if form == "planar" and needs_grad(h, w_oihw, b):
        return ConvUp.apply(h, w_oihw, b, packed)
    if _build.takes_plain(h):
        return conv3x3_up_ref(h, w_oihw, b)
    return _conv3x3_up_cuda(h, w_oihw, b, packed, form)


# B3's backward. _FOLD[u + 1][ky] = the number of output parities py in
# {0, 1} with py - ky + 1 = u: the 3x3 taps that reach dy's row 2i + u
# from the half-resolution row i, for u in -1..2.
_FOLD = ((0, 0, 1), (0, 1, 1), (1, 1, 0), (1, 0, 0))


def _fold_taps(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The 3 taps of ``t`` along ``dim`` -> a new leading dim of the 4
    offsets u + 1 of ``_FOLD``, each the sum of its taps in increasing
    order."""
    taps = [t.select(dim, k) for k in range(3)]
    rows = []
    for row in _FOLD:
        picked = [taps[k] for k in range(3) if row[k]]
        acc = picked[0]
        for p in picked[1:]:
            acc = acc + p
        rows.append(acc)
    return torch.stack(rows)


def bwd_dx_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """diffusers [Co, Ci, 3, 3] -> B3b-dx's [16, Ci, Co] bf16 weights of the
    4x4 stride-2 conv over dy: tap (u + 1) * 4 + (v + 1) holds the sum of
    W[:, :, ky, kx] over the parities with py - ky + 1 = u and
    px - kx + 1 = v: weight slices summed in f32 on the weight's device,
    over ky, then over kx, each in increasing tap order (B3b-dx's fold
    pass takes the same order); no table is copied from the host."""
    co, ci = w_oihw.shape[:2]
    wv = _fold_taps(_fold_taps(w_oihw.float(), 2), 3)   # [v, u, Co, Ci]
    w4 = torch.empty((16, ci, co), dtype=torch.bfloat16,
                     device=w_oihw.device)
    w4.view(4, 4, ci, co).copy_(wv.permute(1, 0, 3, 2))
    return w4


def conv3x3_up_bwd_ref(h: torch.Tensor, w_oihw: torch.Tensor,
                       dy: torch.Tensor):
    """Plain version of B3's backward, from its formula: d(up h) is the
    SAME 3x3 conv of dy with the flipped, transposed weights, dh its 2x2
    sum-pool; dW[co, ci, ky, kx] = sum dy[., Y, X, co] up(h)[., Y + ky - 1,
    X + kx - 1, ci]; db = sum dy. NHWC h [B, H2, W2, Ci], dy [B, 2 H2,
    2 W2, Co]; f32 (f64 for f64 h); (dh in h's dtype, dW and db in the
    weight's)."""
    acc = acc_dtype(h)
    bsz, h2, w2, ci = h.shape
    co = w_oihw.shape[0]
    g = dy.permute(0, 3, 1, 2).to(acc)                      # [B, Co, 2H, 2W]
    w_t = w_oihw.to(acc).flip(2, 3).transpose(0, 1)          # [Ci, Co, 3, 3]
    d_up = F.conv2d(g, w_t, padding=1)
    dh = d_up.reshape(bsz, ci, h2, 2, w2, 2).sum((3, 5)).permute(0, 2, 3, 1)
    up = h.permute(0, 3, 1, 2).to(acc)
    up = up.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    patches = F.unfold(F.pad(up, (1, 1, 1, 1)), 3)           # [B, Ci*9, P]
    dw = torch.einsum("bop,bkp->ok", g.reshape(bsz, co, -1), patches)
    db = g.sum((0, 2, 3))
    return (dh.to(h.dtype), dw.reshape(co, ci, 3, 3).to(w_oihw.dtype),
            db.to(w_oihw.dtype))


def _bf16_nhwc(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous, 16-byte aligned bf16 tensor."""
    t = t.to(torch.bfloat16).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


# B3b's tiles (csrc/conv3x3_up_bwd.cu): dx's block owns an 8 x 16 patch of
# half-resolution pixels x 128 or 160 input channels, its k slices are
# (tap, 64 output channels), split over 1..4 blocks (dx_plan); dw's stage
# is a 4 x 16 patch of positions, its block 128 output x 64 input channels
# of one parity
DX_PATCH, DX_TNS, DX_CK = (8, 16), (128, 160), 64
DW_PATCH, DW_TM, DW_TN = (4, 16), 128, 64


def dx_plan(bsz: int, h2: int, w2: int, ci: int, co: int) -> tuple:
    """(input channels a block, blocks that share an output tile) that
    B3b-dx takes for this shape on the current GPU: the C side's choice
    from the clusters the card holds at once (``csrc/conv3x3_up_bwd.cu::
    dx_plan``)."""
    v = _build.library("conv3x3_up_bwd").sdt_conv3x3_up_bwd_dx_plan(
        bsz, h2, w2, ci, co + co % 64)
    if v == 0:
        raise RuntimeError("B3b-dx's occupancy query failed")
    return v // 8, v % 8


def _bwd_dx_fold_cuda(w_oihw: torch.Tensor) -> torch.Tensor:
    """``bwd_dx_weights`` on the card in one pass (``csrc/conv3x3_up_bwd.cu
    ::fold_kernel``), bit for bit: [16, Ci, Co] bf16 from a bf16 or f32
    [Co, Ci, 3, 3] weight."""
    co, ci = w_oihw.shape[:2]
    if tuple(w_oihw.shape) != (co, ci, 3, 3) or not w_oihw.is_cuda:
        raise ValueError(f"the weight must be [Co, Ci, 3, 3] on a GPU, got "
                         f"{tuple(w_oihw.shape)} on {w_oihw.device}")
    if w_oihw.dtype not in (torch.bfloat16, torch.float32):
        w_oihw = w_oihw.float()
    w_oihw = w_oihw.contiguous()
    w4 = torch.empty((16, ci, co), dtype=torch.bfloat16,
                     device=w_oihw.device)
    err = _build.library("conv3x3_up_bwd").sdt_conv3x3_up_bwd_fold(
        w_oihw.data_ptr(), w4.data_ptr(), ci, co,
        int(w_oihw.dtype == torch.float32), _build.stream_ptr(w_oihw.device))
    _build.check(err, "sdt_conv3x3_up_bwd_fold")
    return w4


def _conv3x3_up_bwd_dx_cuda(dy: torch.Tensor, w_oihw: torch.Tensor,
                            h_shape) -> torch.Tensor:
    """B3b-dx: dh [B, H2, W2, Ci] bf16, the 4x4 stride-2 conv of dy with the
    folded weights; two launches, one count: the fold
    (``_bwd_dx_fold_cuda``), then the conv. Co % 64 == 32 is taken by zero
    output channels appended to dy and the weight (no model's upsample has
    it)."""
    global bwd_dx_launches
    bsz, h2, w2, ci = h_shape
    co = dy.shape[3]
    if ci % 64 or co % 32:
        raise ValueError(f"up-conv backward needs Ci % 64 == 0 and "
                         f"Co % 32 == 0, got Ci={ci}, Co={co}")
    if (tuple(dy.shape) != (bsz, 2 * h2, 2 * w2, co)
            or tuple(w_oihw.shape) != (co, ci, 3, 3)):
        raise ValueError(f"dy {tuple(dy.shape)} and the weight "
                         f"{tuple(w_oihw.shape)} do not match h "
                         f"{tuple(h_shape)}")
    if (dy.dtype != torch.bfloat16 or not dy.is_contiguous()
            or dy.data_ptr() % 16 or w_oihw.device != dy.device):
        raise ValueError("dy must be a contiguous, 16-byte aligned bf16 "
                         "tensor on the weight's GPU")
    if co % 64:
        dy, w_oihw = F.pad(dy, (0, 32)), F.pad(w_oihw, (0, 0, 0, 0, 0, 0,
                                                         0, 32))
        co += 32
    w4 = _bwd_dx_fold_cuda(w_oihw)
    dh = torch.empty(tuple(h_shape), dtype=torch.bfloat16, device=dy.device)
    err = _build.library("conv3x3_up_bwd").sdt_conv3x3_up_bwd_dx_bf16(
        dy.data_ptr(), w4.data_ptr(), dh.data_ptr(), bsz, h2, w2, ci, co,
        _build.stream_ptr(dy.device))
    _build.check(err, "sdt_conv3x3_up_bwd_dx_bf16")
    bwd_dx_launches += 1
    return dh


def _conv3x3_up_bwd_dw_cuda(dy: torch.Tensor, h: torch.Tensor):
    """B3b-dw: (dW [Co, Ci, 3, 3], db [Co]) in f32, one launch: the 16
    parity products, their fixed-order fold into the 9 taps and db."""
    global bwd_dw_launches
    bsz, h2, w2, ci = h.shape
    co = dy.shape[3]
    if ci % 64 or co % 64:
        raise ValueError(f"up-conv backward needs Ci % 64 == 0 and "
                         f"Co % 64 == 0, got Ci={ci}, Co={co}")
    if tuple(dy.shape) != (bsz, 2 * h2, 2 * w2, co):
        raise ValueError(f"dy {tuple(dy.shape)} does not match h "
                         f"{tuple(h.shape)}")
    for t in (dy, h):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.data_ptr() % 16 or t.device != dy.device):
            raise ValueError("dy and h must be contiguous, 16-byte aligned "
                             "bf16 tensors on one GPU")
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=dy.device)
    db = torch.empty(co, dtype=torch.float32, device=dy.device)
    err = _build.library("conv3x3_up_bwd").sdt_conv3x3_up_bwd_dw_bf16(
        dy.data_ptr(), h.data_ptr(), dw.data_ptr(), db.data_ptr(), bsz, h2,
        w2, ci, co, _build.stream_ptr(dy.device))
    _build.check(err, "sdt_conv3x3_up_bwd_dw_bf16")
    bwd_dw_launches += 1
    return dw, db


class ConvUp(torch.autograd.Function):
    """B3 with a backward: on CUDA (bf16) the forward launches B3 as the
    no-grad path does, bit for bit and counted the same, and the backward
    launches B3b-dx for dh and B3b-dw for dW and db where they are needed;
    on the CPU the plain version and ``conv3x3_up_bwd_ref``."""

    @staticmethod
    def forward(ctx, h, w_oihw, b, packed):
        ctx.save_for_backward(h, w_oihw)
        ctx.has_bias = b is not None
        if _build.takes_plain(h):
            return conv3x3_up_ref(h, w_oihw, b)
        return _conv3x3_up_cuda(h, w_oihw, b, packed, "planar")

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        dh = dw = db = None
        if _build.takes_plain(h):
            dh, dw, db = conv3x3_up_bwd_ref(h, w, dy)
        else:
            dy = _bf16_nhwc(dy)
            if need_h:
                dh = _conv3x3_up_bwd_dx_cuda(dy, w.detach(), h.shape)
            if need_w or need_b:
                dw, db = _conv3x3_up_bwd_dw_cuda(dy, h)
                dw, db = dw.to(w.dtype), db.to(w.dtype)
        return (dh if need_h else None, dw if need_w else None,
                db if need_b and ctx.has_bias else None, None)


def flops(b: int, h2: int, w2: int, ci: int, co: int) -> int:
    """Operations of one call: four parities of a K = 4*Ci product; also
    those of each of its backward's dh and dW (16 taps over dy for dh, 16
    parity partials for dW)."""
    return 2 * b * h2 * w2 * co * 4 * ci * 4


# ----------------------------------------------------------- fused conv3x3
# bound a bf16 kernel call is held to against the plain version on the same
# values (chip_smoke.py, tests/test_torch_port_cuda.py), elementwise
# |d| <= BF16_ATOL + BF16_RTOL * |plain|. The two differ by the bf16
# output's rounding and by the prologue's: the plain x*sigmoid(x) rounds
# sigmoid to bf16 first, a bias of up to ~0.4% that adds up over the 9*Ci
# terms of a pixel. On an H100 the largest excess over the relative term
# was 0.031 (SiLU of a shift of 4, outputs to |y| = 14) and 0.011 at the
# decoder's shapes with GN-like affines.
BF16_ATOL = 4e-2
BF16_RTOL = 1e-2

def _pick_tile_h(h: int, w: int, co: int, budget: float = 1.25e6) -> int:
    """The JAX package's row-band height for its fused kernel, kept so that
    ``supports`` takes exactly the same shapes (the CUDA kernel has no row
    bands)."""
    for th in (32, 16, 8, 4, 2, 1):
        if h % th == 0 and h >= th + 2 and th * w * co * 4 <= budget:
            return th
    return 1


def supports(x_shape, ci: int, co: int) -> bool:
    """The JAX package's predicate for the fused conv, kept unchanged so
    routing and launch counts match: the VAE's resnet convs (Ci/Co in
    {128, 256, 512}, H = W in {64..512}) all qualify."""
    b, h, w, _ = x_shape
    th = _pick_tile_h(h, w, co)
    return (ci % 128 == 0 and co % 128 == 0 and w % 16 == 0
            and h % th == 0 and h >= th + 2 and ci <= 1024 and co <= 1024)


def conv3x3_ref(x: torch.Tensor, w_oihw: torch.Tensor,
                b: torch.Tensor | None = None,
                pre_scale: torch.Tensor | None = None,
                pre_shift: torch.Tensor | None = None,
                act: str | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version (the JAX package's ``_fallback``): the pre-affine and
    SiLU at x's dtype, a SAME conv with f32 accumulation, bias and residual
    in f32, the output in x's dtype. NHWC x [B, H, W, Ci], pre_scale and
    pre_shift [B, Ci], residual [B, H, W, Co]."""
    if pre_scale is not None:
        x = (x * pre_scale.to(x.dtype)[:, None, None, :]
             + pre_shift.to(x.dtype)[:, None, None, :])
    if act == "silu":
        x = x * torch.sigmoid(x)
    out = F.conv2d(x.permute(0, 3, 1, 2).float(), w_oihw.float(),
                   padding=1).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def pack_weights_3x3(w_oihw: torch.Tensor, b: torch.Tensor | None = None):
    """diffusers [Co, Ci, 3, 3] -> (the kernel's [Co, 9*Ci] bf16 layout,
    K index (3*dy + dx)*Ci + ci; bias as f32 [Co]). A caller that reuses
    its weights packs them once (``packed=`` of ``conv3x3``)."""
    co, ci = w_oihw.shape[:2]
    wt = (w_oihw.detach().permute(0, 2, 3, 1).reshape(co, 9 * ci)
          .to(torch.bfloat16).contiguous())
    bias = (torch.zeros(co, device=w_oihw.device) if b is None
            else b.detach().float().contiguous())
    return wt, bias


def _nhwc_bf16(t: torch.Tensor, name: str, shape) -> None:
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"{name} must be a contiguous, 16-byte aligned bf16 NHWC tensor "
            f"of shape {tuple(shape)} (channels_last in NCHW terms), got "
            f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _conv3x3_cuda(x, w_oihw, b, pre_scale, pre_shift, act, residual, packed):
    global fused_launches
    check_no_grad("conv3x3 (B4)", x, w_oihw, b, pre_scale, pre_shift,
                  residual)
    tensors = [t for t in (w_oihw, b, pre_scale, pre_shift, residual)
               if t is not None]
    if not x.is_cuda or any(t.device != x.device for t in tensors):
        raise ValueError("x, the weight and every operand must lie on one "
                         "GPU")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    bsz, h, w, ci = x.shape
    co = w_oihw.shape[0]
    _nhwc_bf16(x, "x", (bsz, h, w, ci))
    if tuple(w_oihw.shape) != (co, ci, 3, 3):
        raise ValueError(f"weight {tuple(w_oihw.shape)} does not match "
                         f"Ci={ci}")
    if ci % 32 or co % 128:
        raise ValueError(f"conv kernel needs Ci % 32 == 0 and Co % 128 == 0,"
                         f" got Ci={ci}, Co={co}")
    if act not in (None, "silu"):
        raise ValueError(f"act must be None or 'silu', got {act!r}")
    if (pre_scale is None) != (pre_shift is None):
        raise ValueError("pre_scale and pre_shift come together")
    a = s = None
    if pre_scale is not None:
        if (tuple(pre_scale.shape) != (bsz, ci)
                or tuple(pre_shift.shape) != (bsz, ci)):
            raise ValueError(f"pre_scale/pre_shift must be [B, Ci] = "
                             f"{[bsz, ci]}")
        a = pre_scale.to(torch.bfloat16).contiguous()
        s = pre_shift.to(torch.bfloat16).contiguous()
    if residual is not None:
        _nhwc_bf16(residual, "residual", (bsz, h, w, co))
    wt, bias = pack_weights_3x3(w_oihw, b) if packed is None else packed
    if not (wt.shape == (co, 9 * ci) and wt.dtype == torch.bfloat16
            and wt.is_contiguous() and wt.device == x.device
            and bias.shape == (co,) and bias.dtype == torch.float32
            and bias.device == x.device):
        raise ValueError("packed weights are not pack_weights_3x3(w, b) of "
                         "this weight on this GPU")
    if bias.data_ptr() % 16 or not bias.is_contiguous():
        raise ValueError("the packed bias must be contiguous and 16-byte "
                         "aligned")
    out = torch.empty((bsz, h, w, co), dtype=x.dtype, device=x.device)
    fn = _build.library("conv3x3").sdt_conv3x3_bf16
    err = fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
             None if a is None else a.data_ptr(),
             None if s is None else s.data_ptr(),
             None if residual is None else residual.data_ptr(),
             out.data_ptr(), bsz, h, w, ci, co, int(act == "silu"),
             _build.stream_ptr(x.device))
    _build.check(err, "sdt_conv3x3_bf16")
    fused_launches += 1
    return out


def conv3x3(x: torch.Tensor, w_oihw: torch.Tensor,
            b: torch.Tensor | None = None,
            pre_scale: torch.Tensor | None = None,
            pre_shift: torch.Tensor | None = None, act: str | None = None,
            residual: torch.Tensor | None = None,
            packed=None) -> torch.Tensor:
    """residual + conv3x3_SAME(act(x*pre_scale + pre_shift), w) + b.

    x: NHWC [B, H, W, Ci]; w: diffusers [Co, Ci, 3, 3]; pre_scale and
    pre_shift: optional f32 [B, Ci] GroupNorm affine, applied at x's
    dtype; act: None | 'silu'; residual: [B, H, W, Co]. A CUDA tensor
    launches the kernel (bf16, contiguous NHWC x and residual) or raises;
    a CPU tensor takes the plain version. ``packed``:
    ``pack_weights_3x3(w_oihw, b)``, computed once by a caller that reuses
    the weights; built per call when None."""
    if _build.takes_plain(x):
        return conv3x3_ref(x, w_oihw, b, pre_scale, pre_shift, act, residual)
    return _conv3x3_cuda(x, w_oihw, b, pre_scale, pre_shift, act, residual,
                         packed)


def flops_3x3(b: int, h: int, w: int, ci: int, co: int) -> int:
    """Operations of one fused conv call: a K = 9*Ci product per pixel."""
    return 2 * b * h * w * 9 * ci * co
