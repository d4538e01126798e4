"""SD3 MMDiT transformer with diffusers ``SD3Transformer2DModel`` parameter
names.

Counterpart of ``safe_denoiser_tpu/models/mmdit.py``: patchify with the
cropped fixed 2-D sin-cos position table, timestep + pooled-text
embedding, joint blocks (AdaLN-Zero modulation, one attention over the
concatenated [image ; context] tokens, tanh-GELU MLPs; the last block is
context_pre_only), AdaLN-continuous head, unpatchify. NCHW at the
boundary; computes in the dtype of its parameters with f32 norm
statistics and returns f32.

The joint attention goes through ``layers.dot_product_attention``, so its
[2, 4429, 24, 64] call at 1024^2 with CFG reaches the attention kernel
(or, with ``SDT_INT8_ATTN=1`` under bf16, its int8-QK^T form). The block
projections and MLPs are ``QDense`` layers, which ``ops.quant`` turns to
W8A8 int8. Sequence and pipeline parallelism are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import QDense, dot_product_attention, timestep_embedding
from .t5 import RMSNormFp32


@dataclass(frozen=True)
class MMDiTConfig:
    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    num_heads: int = 24
    head_dim: int = 64
    joint_attention_dim: int = 4096     # T5 / padded-CLIP context width
    caption_projection_dim: int = 1536  # = num_heads * head_dim
    pooled_projection_dim: int = 2048   # CLIP-L (768) + bigG (1280) pooled
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None       # None (SD3-medium) | "rms_norm"


SD3_MEDIUM = MMDiTConfig()


def layer_norm_fp32(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine: f32 statistics, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def pos_embed_2d(embed_dim: int, grid_size: int, base_size: int,
                 top: int = 0, left: int = 0, rows: Optional[int] = None,
                 cols: Optional[int] = None) -> np.ndarray:
    """The [rows*cols, D] crop at (top, left) of diffusers'
    ``get_2d_sincos_pos_embed`` table for a grid_size^2 grid (positions
    scaled by grid_size / base_size, the first half of D from the column
    coordinate), in float64. Each entry depends only on its own position,
    so the crop equals the JAX package's crop of its full table."""
    rows = grid_size if rows is None else rows
    cols = grid_size if cols is None else cols

    def one_d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.arange(grid_size, dtype=np.float64) / (grid_size / base_size)
    gw, gh = np.meshgrid(grid[left:left + cols], grid[top:top + rows])
    return np.concatenate([one_d(embed_dim // 2, gw),
                           one_d(embed_dim // 2, gh)], axis=1)


class AdaLayerNormZero(nn.Module):
    """LN with 6-way (shift/scale/gate x 2) modulation from the embedding."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim)

    def forward(self, x, emb):
        mod = self.linear(F.silu(emb))
        shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, -1)
        h = layer_norm_fp32(x) * (1 + scale[:, None]) + shift[:, None]
        return h, gate, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormContinuous(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, emb):
        scale, shift = self.linear(F.silu(emb)).chunk(2, -1)
        return layer_norm_fp32(x) * (1 + scale[:, None]) + shift[:, None]


class FeedForward(nn.Module):
    """tanh-GELU MLP; diffusers names net.0.proj / net.2."""

    def __init__(self, dim: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = QDense(dim, 4 * dim)
        self.net = nn.ModuleList([proj, nn.Dropout(0.0), QDense(4 * dim, dim)])

    def forward(self, x):
        h = F.gelu(self.net[0].proj(x), approximate="tanh")
        return self.net[2](h)


class JointAttention(nn.Module):
    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool):
        super().__init__()
        dim = cfg.num_heads * cfg.head_dim
        self.cfg = cfg
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj"):
            setattr(self, name, QDense(dim, dim))
        self.to_out = nn.ModuleList([QDense(dim, dim), nn.Dropout(0.0)])
        if not context_pre_only:
            self.to_add_out = QDense(dim, dim)
        if cfg.qk_norm == "rms_norm":
            for name in ("norm_q", "norm_k", "norm_added_q",
                         "norm_added_k"):
                setattr(self, name, RMSNormFp32(cfg.head_dim))
        elif cfg.qk_norm is not None:
            raise ValueError(f"qk_norm {cfg.qk_norm!r}")

    def _qkv(self, h, q, k, v, nq=None, nk=None):
        b, s, _ = h.shape
        shape = (b, s, self.cfg.num_heads, self.cfg.head_dim)
        q, k, v = q(h).view(shape), k(h).view(shape), v(h).view(shape)
        if nq is not None:
            q, k = nq(q), nk(k)
        return q, k, v

    def forward(self, xh, ch):
        rms = self.cfg.qk_norm == "rms_norm"
        xq, xk, xv = self._qkv(xh, self.to_q, self.to_k, self.to_v,
                               *((self.norm_q, self.norm_k) if rms else ()))
        cq, ck, cv = self._qkv(ch, self.add_q_proj, self.add_k_proj,
                               self.add_v_proj,
                               *((self.norm_added_q, self.norm_added_k)
                                 if rms else ()))
        out = dot_product_attention(torch.cat([xq, cq], 1),
                                    torch.cat([xk, ck], 1),
                                    torch.cat([xv, cv], 1))
        b, s, _, _ = out.shape
        out = out.reshape(b, s, -1)
        s_img = xh.shape[1]
        return out[:, :s_img], out[:, s_img:]


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        dim = cfg.num_heads * cfg.head_dim
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = (AdaLayerNormContinuous(dim) if context_pre_only
                              else AdaLayerNormZero(dim))
        self.attn = JointAttention(cfg, context_pre_only)
        self.ff = FeedForward(dim)
        if not context_pre_only:
            self.ff_context = FeedForward(dim)

    def forward(self, x, context, emb):
        xh, x_gate, x_shift_mlp, x_scale_mlp, x_gate_mlp = self.norm1(x, emb)
        if self.context_pre_only:
            ch = self.norm1_context(context, emb)
        else:
            ch, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
                self.norm1_context(context, emb)
        x_out, c_out = self.attn(xh, ch)

        x = x + x_gate[:, None] * self.attn.to_out[0](x_out)
        xh = layer_norm_fp32(x) * (1 + x_scale_mlp[:, None]) \
            + x_shift_mlp[:, None]
        x = x + x_gate_mlp[:, None] * self.ff(xh)
        if self.context_pre_only:
            return x, None
        context = context + c_gate[:, None] * self.attn.to_add_out(c_out)
        ch = layer_norm_fp32(context) * (1 + c_scale_mlp[:, None]) \
            + c_shift_mlp[:, None]
        return x, context + c_gate_mlp[:, None] * self.ff_context(ch)


class _TimestepEmbedder(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig, dim: int):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, dim, p, stride=p)


class MMDiT(nn.Module):
    """forward(sample [B, C, H, W], timesteps scalar or [B], context [B, S,
    joint_dim], pooled [B, P]) -> f32 [B, C, H, W]."""

    def __init__(self, config: MMDiTConfig = SD3_MEDIUM,
                 sp_mesh: Optional[object] = None):
        super().__init__()
        if sp_mesh is not None:
            raise NotImplementedError("sequence parallelism (sp_mesh) is "
                                      "not ported")
        self.config = cfg = config
        dim = cfg.num_heads * cfg.head_dim
        self.pos_embed = _PatchEmbed(cfg, dim)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = _TimestepEmbedder(256, dim)
        self.time_text_embed.text_embedder = _TimestepEmbedder(
            cfg.pooled_projection_dim, dim)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim,
                                          cfg.caption_projection_dim)
        self.transformer_blocks = nn.ModuleList([
            JointBlock(cfg, context_pre_only=(i == cfg.num_layers - 1))
            for i in range(cfg.num_layers)])
        self.norm_out = AdaLayerNormContinuous(dim)
        self.proj_out = nn.Linear(dim, cfg.patch_size ** 2 * cfg.out_channels)
        self._pos_cache: dict = {}

    def _pos(self, gh: int, gw: int, dim: int, device) -> torch.Tensor:
        """The cropped position table, f32, computed once per grid."""
        key = (gh, gw, str(device))
        if key not in self._pos_cache:
            cfg = self.config
            m = cfg.pos_embed_max_size
            table = pos_embed_2d(dim, m, cfg.sample_size // cfg.patch_size,
                                 top=(m - gh) // 2, left=(m - gw) // 2,
                                 rows=gh, cols=gw)
            self._pos_cache[key] = torch.from_numpy(
                table.astype(np.float32)).to(device)
        return self._pos_cache[key]

    def forward(self, sample: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dim = cfg.num_heads * cfg.head_dim
        dtype = self.context_embedder.weight.dtype
        b, _, h, w = sample.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p

        x = self.pos_embed.proj(sample.to(dtype))               # [B,D,gh,gw]
        x = x.flatten(2).transpose(1, 2)                        # [B,gh*gw,D]
        x = x + self._pos(gh, gw, dim, x.device)[None].to(dtype)

        t = torch.as_tensor(timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(b)
        tt = self.time_text_embed
        emb = (tt.timestep_embedder(timestep_embedding(t, 256).to(dtype))
               + tt.text_embedder(pooled_projections.to(dtype)))
        context = self.context_embedder(encoder_hidden_states.to(dtype))
        for blk in self.transformer_blocks:
            x, context = blk(x, context, emb)
        x = self.proj_out(self.norm_out(x, emb))
        c = cfg.out_channels
        x = x.reshape(b, gh, gw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, c, gh * p, gw * p).float()
