"""Plain PyTorch building blocks of the benchmark's reference models.

Every function computes in float32 from a :class:`Params` table of tensors
named as the published checkpoints name them (diffusers / HF transformers
keys). Nothing here imports the program under test. Callers turn TF32 off
(``ieee_f32``) so that a float32 product on the GPU is a float32 product.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

# query rows of one attention block: bounds the [H, rows, S] logits
_ATTN_ROWS = 2048


class Params:
    """A checkpoint's tensors by name, read as float32. ``quant`` (a
    callable on a float32 tensor) rounds every weight and every product's
    input when set: the lower-precision control of the comparison."""

    def __init__(self, tensors: dict, quant=None):
        self.tensors = tensors
        self.quant = quant

    def has(self, name: str) -> bool:
        return name in self.tensors

    def w(self, name: str) -> torch.Tensor:
        t = self.tensors[name].float()
        return t if self.quant is None else self.quant(t)

    def raw(self, name: str) -> torch.Tensor:
        """A weight without rounding (norm scales, embeddings' rows)."""
        return self.tensors[name].float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.quant is None else self.quant(x)


@contextlib.contextmanager
def ieee_f32():
    """float32 products without TF32 inside the block; restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    bias = p.raw(name + ".bias") if p.has(name + ".bias") else None
    return F.linear(p.act(x), p.w(name + ".weight"), bias)


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    bias = p.raw(name + ".bias") if p.has(name + ".bias") else None
    return F.conv2d(p.act(x), p.w(name + ".weight"), bias, stride=stride,
                    padding=padding)


def group_norm(p: Params, name: str, x: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    return F.group_norm(x, groups, p.raw(name + ".weight"),
                        p.raw(name + ".bias"), eps)


def layer_norm(p: Params, name: str, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p.raw(name + ".weight"),
                        p.raw(name + ".bias"), eps)


def layer_norm_plain(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without an affine."""
    return F.layer_norm(x, x.shape[-1:], None, None, eps)


def rms_norm(p: Params, name: str, x: torch.Tensor,
             eps: float) -> torch.Tensor:
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return x * p.raw(name + ".weight")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, mask: torch.Tensor | None = None,
              bias: torch.Tensor | None = None,
              quant=None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over [B, S, H, D] in float32, in
    blocks of query rows. ``mask`` [Sq, Skv] bool (True keeps), ``bias``
    [H, Sq, Skv]; ``quant`` rounds both products' inputs."""
    rnd = (lambda t: t) if quant is None else quant
    b, s_q = q.shape[0], q.shape[1]
    out = torch.empty(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                      device=q.device)
    for i in range(b):
        kt = rnd(k[i].float()).permute(1, 2, 0)          # [H, D, Skv]
        vt = rnd(v[i].float()).permute(1, 0, 2)          # [H, Skv, D]
        for r0 in range(0, s_q, _ATTN_ROWS):
            r1 = min(s_q, r0 + _ATTN_ROWS)
            qt = rnd(q[i, r0:r1].float() * scale).permute(1, 0, 2)
            logits = torch.bmm(qt, kt)                   # [H, rows, Skv]
            if bias is not None:
                logits = logits + bias[:, r0:r1]
            if mask is not None:
                logits = logits.masked_fill(~mask[r0:r1], float("-inf"))
            probs = torch.softmax(logits, dim=-1)
            out[i, r0:r1] = torch.bmm(rnd(probs), vt).permute(1, 0, 2)
    return out


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       shift: float = 0.0, max_period: float = 10000.0
                       ) -> torch.Tensor:
    """diffusers' ``get_timestep_embedding`` in float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def sincos_2d(dim: int, grid: int, base: int, top: int, left: int,
              rows: int, cols: int) -> np.ndarray:
    """The [rows*cols, dim] crop at (top, left) of diffusers'
    ``get_2d_sincos_pos_embed`` for a grid x grid table whose positions are
    scaled by base / grid, in float64."""
    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(grid, dtype=np.float64) * base / grid
    gw, gh = np.meshgrid(coords[left:left + cols], coords[top:top + rows])
    return np.concatenate([one_d(dim // 2, gw), one_d(dim // 2, gh)], axis=1)


# -- parameter tables ---------------------------------------------------
# Each model module lists its checkpoint's tensors as (name, shape, kind,
# fan_in), kind one of "matrix" (a weight of two or more dims), "bias",
# "embedding", "ones", "zeros"; ``weights.py`` draws them from a seed.

def spec_linear(out: list, name: str, n_in: int, n_out: int,
                bias: bool = True) -> None:
    out.append((name + ".weight", (n_out, n_in), "matrix", n_in))
    if bias:
        out.append((name + ".bias", (n_out,), "bias", n_in))


def spec_conv(out: list, name: str, c_in: int, c_out: int, k: int,
              bias: bool = True) -> None:
    fan_in = c_in * k * k
    out.append((name + ".weight", (c_out, c_in, k, k), "matrix", fan_in))
    if bias:
        out.append((name + ".bias", (c_out,), "bias", fan_in))


def spec_norm(out: list, name: str, c: int, bias: bool = True) -> None:
    out.append((name + ".weight", (c,), "ones", 0))
    if bias:
        out.append((name + ".bias", (c,), "zeros", 0))
