"""W8A8 int8 dense layers for the SD3 MMDiT's block projections and the
SD-v1 UNet's wide transformer blocks (opt-in: ``--int8`` / ``enable_int8``).

Counterpart of ``safe_denoiser_tpu/ops/quant.py``. The port's modules carry
torch ``Linear`` weights [N, K] under diffusers names, so JAX's
per-column scale of a [K, N] kernel is a per-output-row scale here.

  * weights: symmetric per-output-channel scales, quantized once when the
    pipeline enables int8 (``quantize_mmdit_params``/``quantize_unet_params``
    on a state dict, ``load_quantized`` into the module); never stored;
  * activations: symmetric per-row (per-token) scales computed per call.

Both round half to even (``torch.round``, as ``jnp.round``) and clip to
+-127, so the int8 values equal the JAX package's bit for bit. The integer
product is exact: on the GPU ``torch._int_mm`` (cuBLASLt, int32
accumulation; the JAX package leaves this dot to XLA, so it is no kernel of
this port), on the CPU a float64 product of the int8 values (exact while
|sum| < 2**53; K <= 6144 gives at most 127**2 * 6144 < 2**27).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

# JointBlock linears quantized (diffusers names under transformer_blocks.i):
# the per-token projections and the MLPs. AdaLN modulation, the embedders
# and proj_out stay in the float dtype, as in the JAX package.
_BLOCK_DENSE = frozenset({
    "attn.to_q", "attn.to_k", "attn.to_v",
    "attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj",
    "attn.to_out.0", "attn.to_add_out",
})
_MLP_DENSE = frozenset({"ff.net.0.proj", "ff.net.2",
                        "ff_context.net.0.proj", "ff_context.net.2"})

# UNet BasicTransformerBlock linears eligible for int8 (subject to the
# min_dim shape gate): attention projections and the GEGLU feed-forward.
_UNET_ATTN_DENSE = frozenset({"to_q", "to_k", "to_v", "to_out.0"})
_UNET_FF_DENSE = frozenset({"ff.net.0.proj", "ff.net.2"})


def quantize_dense_kernel(w: torch.Tensor):
    """Float weight [N, K] -> (int8 weight [N, K], f32 per-row scale [N])."""
    w32 = w.float()
    sw = torch.clamp(w32.abs().amax(dim=1), min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w32 / sw[:, None]), -127, 127)
    return wq.to(torch.int8), sw


def int8_products(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact xq [M, K] @ wq[N, K]^T: int32 on the GPU, float64 on the CPU.
    Sums of these (a K split over slots, ``parallel.tp``) stay exact."""
    if xq.is_cuda:
        (m, k), n = xq.shape, wq.shape[0]
        # cuBLASLt's int8 GEMM wants more than 16 rows and K, N multiples
        # of 8 (a tensor-parallel slot's share can be 4): zero padding
        # adds nothing to the integer sums
        pk, pn, pm = -k % 8, -n % 8, max(0, 17 - m)
        if pk or pm:
            xq = F.pad(xq, (0, pk, 0, pm))
        if pk or pn:
            wq = F.pad(wq, (0, pk, 0, pn))
        return torch._int_mm(xq, wq.t())[:m, :n]
    return xq.double() @ wq.double().t()


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact xq [M, K] @ wq[N, K]^T as f32 [M, N] (each int32 sum rounded
    once to f32, as JAX's ``s32.astype(f32)``)."""
    return int8_products(xq, wq).float()


def quantize_rows(x32: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """f32 activations -> int8 at the per-row scales ``sx`` (round half to
    even, clip to +-127)."""
    return torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)


def int8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[..., K] @ int8 weight [N, K]^T with dynamic per-row activation
    quantization; f32 dequant (y * sx) * sw, f32 bias, output in ``dtype``."""
    x32 = x.float()
    sx = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    xq = quantize_rows(x32, sx)
    lead = x.shape[:-1]
    y = _int8_matmul(xq.reshape(-1, x.shape[-1]), wq)
    y = y.reshape(*lead, wq.shape[0]) * sx * sw.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def _mmdit_weight(name: str) -> bool:
    """True for ``transformer_blocks.<i>.<dense>.weight`` keys to quantize."""
    parts = name.split(".")
    if (len(parts) < 4 or parts[0] != "transformer_blocks"
            or parts[-1] != "weight"):
        return False
    mod = ".".join(parts[2:-1])
    return mod in _BLOCK_DENSE or mod in _MLP_DENSE


def _unet_weight(name: str) -> bool:
    """``<...>.attentions.<j>.transformer_blocks.<k>.(attn1|attn2|ff)...``
    weight keys (mid_block's too)."""
    if not name.endswith(".weight") or ".attentions." not in name:
        return False
    _, sep, tail = name.partition(".transformer_blocks.")
    if not sep:
        return False
    mod = ".".join(tail.split(".")[1:-1])      # after the block index
    attn, _, dense = mod.partition(".")
    return ((attn in ("attn1", "attn2") and dense in _UNET_ATTN_DENSE)
            or mod in _UNET_FF_DENSE)


def quantize_mmdit_params(state_dict: dict):
    """MMDiT state dict -> (state dict with int8 block-linear weights,
    {"<module>.weight_scale": f32 [N]}). Biases and every other entry are
    the caller's tensors, unchanged; the input dict is not modified."""
    return _quantize_state_dict(state_dict,
                                lambda name, w: _mmdit_weight(name),
                                what="MMDiT block dense")


def quantize_unet_params(state_dict: dict, min_dim: int = 1280):
    """SD-v1 UNet state dict -> (state dict, scales), selective by shape:
    only transformer-block linears with ``min(N, K) >= min_dim`` quantize
    (level 2 and the mid block at the default)."""
    return _quantize_state_dict(
        state_dict,
        lambda name, w: _unet_weight(name) and min(w.shape) >= min_dim,
        what=f"UNet transformer dense (min_dim={min_dim})")


def _quantize_state_dict(state_dict: dict,
                         select: Callable[[str, torch.Tensor], bool],
                         what: str):
    out = dict(state_dict)
    scales: dict[str, torch.Tensor] = {}
    for name, w in state_dict.items():
        if not select(name, w):
            continue
        if w.dtype == torch.int8:
            # re-quantizing int8 weights would replace the real scales with
            # max|wq|/127 ~ 1.0 (outputs off by 100-1000x): refuse instead
            raise ValueError(
                f"{name} is already int8 -- the weights were quantized "
                "before; quantize the original float weights")
        wq, sw = quantize_dense_kernel(w)
        out[name] = wq
        scales[name[:-len("weight")] + "weight_scale"] = sw
    if not scales:
        raise ValueError(f"no {what} kernels found to quantize")
    return out, scales


def load_quantized(module: torch.nn.Module, state_dict: dict,
                   scales: dict) -> int:
    """Put the int8 weights of ``state_dict`` and their ``scales`` into
    ``module``'s ``QDense`` layers (in place, on the weights' device).
    Returns the number of layers quantized."""
    from ..models.layers import QDense
    n = 0
    for key, sw in scales.items():
        name = key[:-len(".weight_scale")]
        layer = module.get_submodule(name)
        if not isinstance(layer, QDense):
            raise TypeError(f"{name} is a {type(layer).__name__}, not a "
                            "QDense")
        layer.set_int8(state_dict[name + ".weight"], sw)
        n += 1
    return n
