"""SD3 MMDiT transformer with diffusers ``SD3Transformer2DModel`` parameter
names.

Counterpart of ``safe_denoiser_tpu/models/mmdit.py``: patchify with the
cropped fixed 2-D sin-cos position table, timestep + pooled-text
embedding, joint blocks (AdaLN-Zero modulation, one attention over the
concatenated [image ; context] tokens, tanh-GELU MLPs; the last block is
context_pre_only), AdaLN-continuous head, unpatchify. NCHW at the
boundary; computes in the dtype of its parameters with f32 norm
statistics and returns f32.

Both streams are carried token-major, as contiguous [B, S, D] rows, so each
projection takes its input as it is (no copy, the bias in the GEMM). Each
modulated LayerNorm (f32 statistics, no affine, eps 1e-6) and gated
residual goes to ``ops.adaln``: one launch of its kernel on CUDA, its plain
version on the CPU, differentiable under autograd.

The joint attention goes through ``layers.dot_product_attention``, so its
[2, 4429, 24, 64] call at 1024^2 with CFG reaches the attention kernel
(or, with ``SDT_INT8_ATTN=1`` under bf16, its int8-QK^T form). The block
projections and MLPs are ``QDense`` layers, which ``ops.quant`` turns to
W8A8 int8. ``MMDiT(sp_mesh=...)`` splits the image tokens over a ``seq``
axis (``parallel/sp.py``), ``MMDiT(pp_mesh=...)`` with ``forward(...,
pp_params=)`` runs blocks 0..L-2 as a GPipe pipeline over a ``pipe`` axis
(``parallel/pp.py``), and ``parallel.shard_params_tp`` makes the block
attention and MLPs tensor-parallel (``parallel/tp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import adaln, qk_rope
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
        return adaln.adaln(x, scale, shift), gate, shift_mlp, scale_mlp, \
            gate_mlp


class AdaLayerNormContinuous(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, emb):
        scale, shift = self.linear(F.silu(emb)).chunk(2, -1)
        return adaln.adaln(x, scale, shift)


class FeedForward(nn.Module):
    """tanh-GELU MLP; diffusers names net.0.proj / net.2. Tensor-parallel
    under ``_tp`` (``parallel.tp.feed_forward``)."""

    _tp = None

    def __init__(self, dim: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = QDense(dim, 4 * dim)
        self.net = nn.ModuleList([proj, nn.Dropout(0.0), QDense(4 * dim, dim)])

    def forward(self, x):
        if self._tp is not None:
            from ..parallel import tp
            return tp.feed_forward(self, x)
        h = F.gelu(self.net[0].proj(x), approximate="tanh")
        return self.net[2](h)


class JointAttention(nn.Module):
    """q/k/v of both streams and one attention over [image ; context];
    the output projections are applied by the block. Tensor-parallel
    under ``_tp`` (``parallel.tp.joint_attention``). With ``rope`` (FLUX's
    double block, ``models/flux.py``) the joint sequence is [context ;
    image] and q and k are RMS-normed and rotated on the way in."""

    _tp = None

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

    def qkv(self, xh, ch):
        """(xq, xk, xv, cq, ck, cv), each [B, S, H, D]."""
        rms = self.cfg.qk_norm == "rms_norm"
        xq, xk, xv = self._qkv(xh, self.to_q, self.to_k, self.to_v,
                               *((self.norm_q, self.norm_k) if rms else ()))
        cq, ck, cv = self._qkv(ch, self.add_q_proj, self.add_k_proj,
                               self.add_v_proj,
                               *((self.norm_added_q, self.norm_added_k)
                                 if rms else ()))
        return xq, xk, xv, cq, ck, cv

    def forward(self, xh, ch, rope=None):
        """(image rows, context rows) of the attention's output [B, S, H*D]
        before the output projections."""
        if rope is not None:
            return self._forward_rope(xh, ch, rope)
        xq, xk, xv, cq, ck, cv = self.qkv(xh, ch)
        out = dot_product_attention(torch.cat([xq, cq], 1),
                                    torch.cat([xk, ck], 1),
                                    torch.cat([xv, cv], 1))
        b, s, _, _ = out.shape
        out = out.reshape(b, s, -1)
        s_img = xh.shape[1]
        return out[:, :s_img], out[:, s_img:]

    def _forward_rope(self, xh, ch, rope):
        """FLUX's joint attention: over [context ; image], each stream's q
        and k RMS-normed per head (its ``norm_*`` weights) and rotated by
        ``rope`` = (cos, sin) [S, D] f32, in one ``ops.qk_rope`` launch
        that writes the joint q, k and v."""
        heads, dh = self.cfg.num_heads, self.cfg.head_dim

        def segment(h, q, k, v, nq, nk):
            shape = (h.shape[0], h.shape[1], heads, dh)
            return (q(h).view(shape), k(h).view(shape), v(h).view(shape),
                    nq.weight, nk.weight)

        q, k, v = qk_rope.qk_rope(
            [segment(ch, self.add_q_proj, self.add_k_proj, self.add_v_proj,
                     self.norm_added_q, self.norm_added_k),
             segment(xh, self.to_q, self.to_k, self.to_v, self.norm_q,
                     self.norm_k)], *rope, eps=self.norm_q.eps)
        out = dot_product_attention(q, k, v)
        b, s, _, _ = out.shape
        out = out.reshape(b, s, -1)
        s_ctx = ch.shape[1]
        return out[:, s_ctx:], out[:, :s_ctx]


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

    def _modulate(self, x, context, emb):
        """(xh, ch, the image stream's gates, the context's or None)."""
        xh, *x_mod = self.norm1(x, emb)
        if self.context_pre_only:
            return xh, self.norm1_context(context, emb), x_mod, None
        ch, *c_mod = self.norm1_context(context, emb)
        return xh, ch, x_mod, c_mod

    def _finish(self, x, context, x_att, c_att, x_mod, c_mod):
        """The residuals and MLPs after the projected attention outputs."""
        x_gate, x_shift_mlp, x_scale_mlp, x_gate_mlp = x_mod
        x, xh = adaln.adaln(x, x_scale_mlp, x_shift_mlp, x_gate, x_att)
        x = adaln.adaln(x, gate=x_gate_mlp, delta=self.ff(xh))
        if self.context_pre_only:
            return x, None
        c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = c_mod
        context, ch = adaln.adaln(context, c_scale_mlp, c_shift_mlp, c_gate,
                                  c_att)
        return x, adaln.adaln(context, gate=c_gate_mlp,
                              delta=self.ff_context(ch))

    def forward(self, x, context, emb, rope=None):
        """(x, context) after the block; ``rope``: FLUX's rotary tables
        (``JointAttention``)."""
        if rope is not None and self.attn._tp is not None:
            # parallel.tp.joint_attention joins [image ; context] and
            # applies no rotary
            raise NotImplementedError("the rotary joint attention has no "
                                      "tensor-parallel form")
        xh, ch, x_mod, c_mod = self._modulate(x, context, emb)
        if self.attn._tp is not None:
            from ..parallel import tp
            x_att, c_att = tp.joint_attention(self.attn, xh, ch)
        else:
            x_out, c_out = self.attn(xh, ch, rope)
            x_att = self.attn.to_out[0](x_out)
            c_att = (None if self.context_pre_only
                     else self.attn.to_add_out(c_out))
        return self._finish(x, context, x_att, c_att, x_mod, c_mod)

    def forward_sp(self, xs: list, cs: list, es: list, mesh, axes):
        """The block with the image tokens split over the ``seq`` slots
        (``axes`` = (data, seq)): xs one token slice a slot, cs and es one
        copy a slot; each slot's pointwise math runs on its slice, the
        joint attention is ``parallel.sp.sp_joint_attention``."""
        from ..parallel.mesh import module_on, on_slot
        from ..parallel.sp import sp_joint_attention
        blks = [module_on(self, x.device) for x in xs]
        pre, qkv = [], []
        for b, x, c, e in zip(blks, xs, cs, es):
            with on_slot(x.device):
                pre.append(b._modulate(x, c, e))
                qkv.append(b.attn.qkv(pre[-1][0], pre[-1][1]))
        x_out, c_out = sp_joint_attention(
            *([q[i] for q in qkv] for i in range(6)), mesh,
            seq_axis=axes[1], data_axis=axes[0])
        new_x, new_c = [], []
        for b, x, c, p, xo, co in zip(blks, xs, cs, pre, x_out, c_out):
            with on_slot(x.device):
                x_att = b.attn.to_out[0](xo.reshape(*xo.shape[:2], -1))
                c_att = (None if self.context_pre_only else
                         b.attn.to_add_out(co.reshape(*co.shape[:2], -1)))
                x, c = b._finish(x, c, x_att, c_att, p[2], p[3])
            new_x.append(x)
            new_c.append(c)
        return new_x, new_c


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
    joint_dim], pooled [B, P], pp_params=None) -> f32 [B, C, H, W].

    ``sp_mesh``: a mesh with a ``sp_axes[1]`` (seq) axis; the image tokens
    run split over it through every block, and where it has a
    ``sp_axes[0]`` (data) axis the batch rows split over that. ``pp_mesh``
    with ``pp_params`` (``parallel.stack_block_params`` /
    ``shard_stacked_pp`` of this model's blocks): blocks 0..L-2 run as a
    GPipe pipeline of ``pp_microbatches`` microbatches over ``pp_axes[1]``
    (pipe), the rows over ``pp_axes[0]`` where the mesh has it. Both are
    plain attributes."""

    def __init__(self, config: MMDiTConfig = SD3_MEDIUM,
                 sp_mesh: Optional[object] = None,
                 sp_axes: tuple = ("data", "seq"),
                 pp_mesh: Optional[object] = None,
                 pp_axes: tuple = ("data", "pipe"),
                 pp_microbatches: int = 2):
        super().__init__()
        self.sp_mesh, self.sp_axes = sp_mesh, tuple(sp_axes)
        self.pp_mesh, self.pp_axes = pp_mesh, tuple(pp_axes)
        self.pp_microbatches = pp_microbatches
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

    def _blocks_sp(self, x, context, emb):
        """Every block with the image tokens split over the seq slots; x
        gathered back on its device after the last."""
        from ..parallel.comm import all_gather
        from ..parallel.sp import constrain_seq
        mesh, axes = self.sp_mesh, self.sp_axes
        xs = constrain_seq(x, mesh, seq_axis=axes[1], data_axis=axes[0])
        cs = [context.to(p.device) for p in xs]
        es = [emb.to(p.device) for p in xs]
        for blk in self.transformer_blocks:
            xs, cs = blk.forward_sp(xs, cs, es, mesh, axes)
        return all_gather(xs, 1, [x.device])[0]

    def _blocks(self, x, context, emb, pp_params=None):
        cfg = self.config
        if self.pp_mesh is not None and pp_params is not None:
            from ..parallel.pp import pp_blocks
            mesh = self.pp_mesh
            data_ax = (self.pp_axes[0] if self.pp_axes[0] in mesh.axis_names
                       else None)
            x, context = pp_blocks(cfg, pp_params, x, context, emb, mesh,
                                   n_micro=self.pp_microbatches,
                                   pipe_axis=self.pp_axes[1],
                                   data_axis=data_ax)
            return self.transformer_blocks[-1](x, context, emb)[0]
        if self.sp_mesh is not None:
            from ..parallel.mesh import over_axis
            return over_axis(self.sp_mesh, self.sp_axes[0], self._blocks_sp,
                             x, context, emb)
        for blk in self.transformer_blocks:
            x, context = blk(x, context, emb)
        return x

    def forward(self, sample: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor,
                pp_params=None) -> torch.Tensor:
        cfg = self.config
        dim = cfg.num_heads * cfg.head_dim
        dtype = self.context_embedder.weight.dtype
        b, _, h, w = sample.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p

        x = self.pos_embed.proj(sample.to(dtype))               # [B,D,gh,gw]
        # token-major rows: an elementwise op keeps its first operand's
        # layout, so a transposed view would stay transposed in every block
        x = x.flatten(2).transpose(1, 2).contiguous()           # [B,gh*gw,D]
        x = x + self._pos(gh, gw, dim, x.device)[None].to(dtype)

        t = torch.as_tensor(timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(b)
        tt = self.time_text_embed
        emb = (tt.timestep_embedder(timestep_embedding(t, 256).to(dtype))
               + tt.text_embedder(pooled_projections.to(dtype)))
        context = self.context_embedder(encoder_hidden_states.to(dtype))
        x = self._blocks(x, context, emb, pp_params)
        x = self.proj_out(self.norm_out(x, emb))
        c = cfg.out_channels
        x = x.reshape(b, gh, gw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, c, gh * p, gw * p).float()
