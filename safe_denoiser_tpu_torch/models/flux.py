"""FLUX.1 transformer with diffusers ``FluxTransformer2DModel`` parameter
names (no counterpart in the JAX package).

Packed latents [B, N, in_channels] (2x2 patches of the 16-channel latents,
``pipeline/sampler.py::pack_latents``) and the T5 states [B, L,
joint_attention_dim] are embedded to the model width; the conditioning
``emb`` is the timestep embedder's output on ``timestep_embedding(1000 t)``
plus, for a guidance-distilled model, the guidance embedder's on
``timestep_embedding(1000 g)``, plus the pooled CLIP text's projection.
Then:

  * ``num_layers`` double-stream blocks: ``mmdit.JointBlock`` (AdaLN-Zero
    on both streams, tanh-GELU MLPs, each modulated LayerNorm and gated
    residual one ``ops.adaln`` launch) whose joint attention runs over
    [text ; image] with q, k, v biased, per-head RMSNorm (``norm_q``,
    ``norm_k``, ``norm_added_q``, ``norm_added_k``) and the rotary
    position embedding on q and k (``JointAttention(rope=)``);
  * ``num_single_layers`` single-stream blocks over the joined [text ;
    image] stream: one modulated LayerNorm (``AdaLayerNormZeroSingle``: shift,
    scale, gate) feeds the attention (q, k, v, qk-RMSNorm and rotary, no
    output projection) and the tanh-GELU MLP side by side, and
    x <- x + gate * proj_out([attention ; MLP]);
  * the image tokens sliced off, ``AdaLayerNormContinuous`` (scale, then
    shift) and ``proj_out`` back to ``in_channels``.

Rotary: positions (0, 0, 0) for every text token and (0, row, col) for the
image's grid; each axis of ``axes_dims_rope`` takes frequencies
10000^(-2i/d) (float64), cos and sin repeated pairwise and joined across the
axes into [S, head_dim] f32 tables (``rope_tables``); x' = x cos + rot(x)
sin with rot (a, b) -> (-b, a) pairwise. In both kinds of block the
qk-RMSNorm and the rotary of q and k are one ``ops.qk_rope`` launch, which
writes the joint q and k (in the double block v too) that the attention
(``layers.dot_product_attention``: B1 on CUDA at [B, S, 24, 128]) reads.

Computes in the dtype of its parameters (f32 norm statistics, rotary and
timestep embeddings) and returns f32. Departures from diffusers: the
timestep and guidance are scaled by 1000 in f32 (diffusers first rounds
them to the model's dtype); the rotary tables are cached per (text
length, grid, device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import adaln, qk_rope
from .layers import QDense, dot_product_attention, timestep_embedding
from .mmdit import (AdaLayerNormContinuous, JointBlock, _TimestepEmbedder)
from .t5 import RMSNormFp32


@dataclass(frozen=True)
class FluxConfig:
    """``transformer/config.json``'s keys (``num_heads`` and ``head_dim``
    are ``num_attention_heads`` and ``attention_head_dim``; patch size 1,
    ``out_channels`` = ``in_channels``). ``qk_norm`` is fixed, not a
    field: FLUX's blocks always RMS-norm q and k (``mmdit.JointAttention``
    reads it to build ``norm_q`` and the rest)."""
    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    num_heads: int = 24
    head_dim: int = 128
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: tuple = (16, 56, 56)
    qk_norm: ClassVar[str] = "rms_norm"


FLUX_DEV = FluxConfig()
THETA = 10000.0   # the rotary's base (diffusers' ``FluxPosEmbed``)
MLP_RATIO = 4     # the single block's MLP width over the model width


def position_ids(txt_len: int, gh: int, gw: int) -> np.ndarray:
    """[txt_len + gh*gw, 3] float32 positions of the joint [text ; image]
    sequence: zeros for the text (diffusers' ``text_ids``), (0, row, col)
    for the image grid (``_prepare_latent_image_ids``)."""
    img = np.zeros((gh, gw, 3), np.float32)
    img[..., 1] = np.arange(gh, dtype=np.float32)[:, None]
    img[..., 2] = np.arange(gw, dtype=np.float32)[None, :]
    return np.concatenate([np.zeros((txt_len, 3), np.float32),
                           img.reshape(gh * gw, 3)])


def rope_tables(ids: np.ndarray, axes_dims):
    """(cos, sin), each float32 [S, sum(axes_dims)], of positions ``ids``
    [S, len(axes_dims)]: diffusers' ``FluxPosEmbed`` (per axis d the
    frequencies THETA^(-2i/d) in float64, ``repeat_interleave_real``)."""
    pos = ids.astype(np.float32).astype(np.float64)
    cos, sin = [], []
    for i, d in enumerate(axes_dims):
        freqs = 1.0 / THETA ** (np.arange(0, d, 2, dtype=np.float64)[:d // 2]
                                / d)
        angles = np.outer(pos[:, i], freqs)
        cos.append(np.repeat(np.cos(angles), 2, axis=1))
        sin.append(np.repeat(np.sin(angles), 2, axis=1))
    return (np.concatenate(cos, 1).astype(np.float32),
            np.concatenate(sin, 1).astype(np.float32))


class AdaLayerNormZeroSingle(nn.Module):
    """LN with 3-way (shift, scale, gate) modulation from the embedding."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 3 * dim)

    def forward(self, x, emb):
        shift, scale, gate = self.linear(F.silu(emb)).chunk(3, -1)
        return adaln.adaln(x, scale, shift), gate


class _SingleAttention(nn.Module):
    """The single block's q/k/v with their per-head RMSNorms (diffusers'
    ``Attention(pre_only=True)``: no output projection)."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        dim = cfg.num_heads * cfg.head_dim
        self.cfg = cfg
        for name in ("to_q", "to_k", "to_v"):
            setattr(self, name, QDense(dim, dim))
        self.norm_q = RMSNormFp32(cfg.head_dim)
        self.norm_k = RMSNormFp32(cfg.head_dim)

    def forward(self, h, rope):
        shape = (h.shape[0], h.shape[1], self.cfg.num_heads,
                 self.cfg.head_dim)
        q, k, v = qk_rope.qk_rope(
            [(self.to_q(h).view(shape), self.to_k(h).view(shape),
              self.to_v(h).view(shape), self.norm_q.weight,
              self.norm_k.weight)], *rope, eps=self.norm_q.eps)
        out = dot_product_attention(q, k, v)
        return out.reshape(*h.shape[:2], -1)


class FluxSingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        dim = cfg.num_heads * cfg.head_dim
        hidden = dim * MLP_RATIO
        self.norm = AdaLayerNormZeroSingle(dim)
        self.proj_mlp = QDense(dim, hidden)
        self.proj_out = QDense(dim + hidden, dim)
        self.attn = _SingleAttention(cfg)

    def forward(self, x, emb, rope):
        h, gate = self.norm(x, emb)
        mlp = F.gelu(self.proj_mlp(h), approximate="tanh")
        att = self.attn(h, rope)
        return adaln.adaln(x, gate=gate, delta=self.proj_out(
            torch.cat([att, mlp], -1)))


class FluxTransformer(nn.Module):
    """forward(hidden_states [B, N, in_channels] packed, encoder_hidden_states
    [B, L, joint_attention_dim], pooled_projections [B, P], timestep
    (sigma, scalar or [B]), guidance (scalar or [B], guidance-distilled
    models), grid=(rows, cols) of the packed image with rows * cols = N)
    -> f32 [B, N, in_channels]."""

    def __init__(self, config: FluxConfig = FLUX_DEV):
        super().__init__()
        self.config = cfg = config
        dim = cfg.num_heads * cfg.head_dim
        if sum(cfg.axes_dims_rope) != cfg.head_dim:
            raise ValueError(f"axes_dims_rope {cfg.axes_dims_rope} must sum "
                             f"to the head dim {cfg.head_dim}")
        self.x_embedder = nn.Linear(cfg.in_channels, dim)
        self.time_text_embed = nn.Module()
        self.time_text_embed.timestep_embedder = _TimestepEmbedder(256, dim)
        if cfg.guidance_embeds:
            self.time_text_embed.guidance_embedder = _TimestepEmbedder(256,
                                                                       dim)
        self.time_text_embed.text_embedder = _TimestepEmbedder(
            cfg.pooled_projection_dim, dim)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, dim)
        self.transformer_blocks = nn.ModuleList([
            JointBlock(cfg) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList([
            FluxSingleBlock(cfg) for _ in range(cfg.num_single_layers)])
        self.norm_out = AdaLayerNormContinuous(dim)
        self.proj_out = nn.Linear(dim, cfg.in_channels)
        self._rope_cache: dict = {}

    def rope(self, txt_len: int, gh: int, gw: int, device) -> tuple:
        """The (cos, sin) tables of [text ; image] on ``device``, f32,
        computed once per (text length, grid, device)."""
        key = (txt_len, gh, gw, str(device))
        if key not in self._rope_cache:
            cfg = self.config
            self._rope_cache[key] = tuple(
                torch.from_numpy(t).to(device) for t in rope_tables(
                    position_ids(txt_len, gh, gw), cfg.axes_dims_rope))
        return self._rope_cache[key]

    def _embed(self, values, b: int, device, dtype) -> torch.Tensor:
        """``timestep_embedding(1000 v, 256)`` of a scalar or [B] value."""
        v = torch.as_tensor(values, dtype=torch.float32, device=device)
        if v.dim() == 0:
            v = v.expand(b)
        return timestep_embedding(1000.0 * v, 256).to(dtype)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor, timestep,
                guidance=None, grid: tuple | None = None) -> torch.Tensor:
        cfg = self.config
        dtype = self.x_embedder.weight.dtype
        b, n, _ = hidden_states.shape
        gh, gw = grid if grid is not None else (int(round(n ** 0.5)),) * 2
        if gh * gw != n:
            raise ValueError(f"grid {grid} does not hold {n} image tokens")
        dev = hidden_states.device
        x = self.x_embedder(hidden_states.to(dtype))
        tt = self.time_text_embed
        emb = tt.timestep_embedder(self._embed(timestep, b, dev, dtype))
        if cfg.guidance_embeds:
            if guidance is None:
                raise ValueError("a guidance-distilled model needs guidance")
            emb = emb + tt.guidance_embedder(self._embed(guidance, b, dev,
                                                         dtype))
        emb = emb + tt.text_embedder(pooled_projections.to(dtype))
        c = self.context_embedder(encoder_hidden_states.to(dtype))
        txt = c.shape[1]
        rope = self.rope(txt, gh, gw, dev)
        for blk in self.transformer_blocks:
            x, c = blk(x, c, emb, rope)
        x = torch.cat([c, x], 1)
        for blk in self.single_transformer_blocks:
            x = blk(x, emb, rope)
        x = self.norm_out(x[:, txt:], emb)
        return self.proj_out(x).float()
