"""SD-v1.x UNet2DConditionModel with diffusers parameter names.

Counterpart of ``safe_denoiser_tpu/models/unet.py``: same block order and
numerics, NCHW at the boundary. On the GPU the activations run
channels_last, so the [B, H*W, C] views of the normalizations, the
attention tokens and the upsample kernel's NHWC input are free. An
HF-layout ``unet/`` state dict loads with ``load_state_dict(strict=True)``.
``forward(..., freeu=FreeUConfig)`` applies FreeU / the SafeGuard filters
(``models/fourier.py``) on the up path at the two widest channel counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as c3
from .fourier import apply_skip_filter
from .layers import (
    Attention,
    FeedForward,
    GroupNorm32,
    LayerNormFp32,
    timestep_embedding,
)


@dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # SD-v1 configs store attention_head_dim=8, which diffusers reads as the
    # number of heads for this architecture
    num_attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_layers: int = 1
    freq_shift: int = 0
    flip_sin_to_cos: bool = True


SD14_UNET = UNetConfig()


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm32(cin, groups, eps, act="silu")
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm32(cout, groups, eps, act="silu")
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNormFp32(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNormFp32(dim)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNormFp32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, ch: int, heads: int, context_dim: int, layers: int,
                 groups: int):
        super().__init__()
        self.norm = GroupNorm32(ch, groups, 1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, ch // heads, context_dim)
             for _ in range(layers)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        t = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            t = blk(t, context)
        x = t.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + res


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def cached_pack(conv: nn.Conv2d, attr: str, pack):
    """``pack(conv.weight, conv.bias)``, kept on ``conv`` under ``attr`` and
    rebuilt only when the weight or bias is replaced or changed in place
    (``load_state_dict``, ``.to``, an optimizer step; not a write through
    ``.data``, which bumps no version counter). The cache keeps the tensors
    it was built from alive, so no other tensor can take their memory
    address while the key names it."""
    params = [t for t in (conv.weight, conv.bias) if t is not None]
    key = [(t.data_ptr(), t._version) for t in params]
    cache = getattr(conv, attr, None)
    if cache is None or cache[0] != key:
        cache = (key, [t.detach() for t in params],
                 pack(conv.weight, conv.bias))
        setattr(conv, attr, cache)
    return cache[2]


def _packed_up_weights(conv: nn.Conv2d):
    """``c3.pack_weights`` of ``conv``, packed once per weight version."""
    return cached_pack(conv, "_up_packed", c3.pack_weights)


def upsample_conv(conv: nn.Conv2d, x: torch.Tensor,
                  form: str = "planar") -> torch.Tensor:
    """conv(nearest_2x(x)) for NCHW x. bf16 inputs of the shapes
    ``supports_up`` takes go through ``conv3x3_up`` in ``form`` on the
    NHWC view (the kernel on the GPU, with weights packed once per module;
    its plain version on the CPU); the rest upsample and convolve."""
    b, c, h, w = x.shape
    if (x.dtype == torch.bfloat16
            and c3.supports_up((b, h, w, c), c, conv.out_channels)):
        packed = _packed_up_weights(conv) if x.is_cuda else None
        y = c3.conv3x3_up(x.permute(0, 2, 3, 1).contiguous(), conv.weight,
                          conv.bias, packed=packed, form=form)
        return y.permute(0, 3, 1, 2)
    return conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Upsample2D(nn.Module):
    """The UNet's upsample: always the planar form, whatever SDT_UP_FORM
    says, as the JAX package hard-codes it (its 640-channel weights fit
    VMEM only per parity)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_conv(self.conv, x, "planar")


class _Block(nn.Module):
    """Holder giving diffusers' down/up block names (resnets, attentions,
    downsamplers / upsamplers)."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig = SD14_UNET):
        super().__init__()
        self.config = cfg = config
        chans = cfg.block_out_channels
        n = len(chans)
        heads, groups, eps = (cfg.num_attention_heads, cfg.norm_num_groups,
                              cfg.norm_eps)
        tdim = chans[0] * 4
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(chans[0], tdim)
        self.time_embedding.linear_2 = nn.Linear(tdim, tdim)

        def transformer(ch):
            return Transformer2DModel(ch, heads, cfg.cross_attention_dim,
                                      cfg.transformer_layers, groups)

        self.down_blocks = nn.ModuleList()
        cin = chans[0]
        for i, ch in enumerate(chans):
            blk = _Block()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(cin if j == 0 else ch, ch,
                                                 tdim, groups, eps))
                if i < n - 1:
                    blk.attentions.append(transformer(ch))
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
            self.down_blocks.append(blk)
            cin = ch

        mid = chans[-1]
        self.mid_block = _Block()
        self.mid_block.resnets.extend([
            ResnetBlock2D(mid, mid, tdim, groups, eps),
            ResnetBlock2D(mid, mid, tdim, groups, eps)])
        self.mid_block.attentions.append(transformer(mid))

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chans))
        prev = mid
        for i, ch in enumerate(rev):
            blk = _Block()
            skip_chans = self._skip_channels(i)
            for j in range(cfg.layers_per_block + 1):
                cin = prev if j == 0 else ch
                blk.resnets.append(ResnetBlock2D(cin + skip_chans[j], ch,
                                                 tdim, groups, eps))
                if i > 0:
                    blk.attentions.append(transformer(ch))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
            prev = ch

        self.conv_norm_out = GroupNorm32(chans[0], groups, eps, act="silu")
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def _skip_channels(self, i: int) -> list[int]:
        """Channels of the skips popped by up block i, in pop order."""
        cfg = self.config
        chans = cfg.block_out_channels
        skips = [chans[0]]
        for k, ch in enumerate(chans):
            skips += [ch] * cfg.layers_per_block
            if k < len(chans) - 1:
                skips.append(ch)
        per = cfg.layers_per_block + 1
        popped = list(reversed(skips))
        return popped[i * per:(i + 1) * per]

    def forward(self, sample: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                freeu=None) -> torch.Tensor:
        """sample [B, C, H, W]; timesteps scalar or [B]; context [B, S, D].
        Computes in the parameters' dtype and returns f32 [B, C, H, W].
        ``freeu``: a ``FreeUConfig``; where the up path's backbone features
        have the widest (b1, s1) or second widest (b2, s2) channel count,
        their first half is scaled by b and the skip goes through
        ``apply_skip_filter`` with s. The SafeGuard modes need the 3-way
        [uncond, cond, re-attention] batch."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        dev = sample.device
        b = sample.shape[0]
        t = torch.as_tensor(timesteps, device=dev)
        if t.dim() == 0:
            t = t.expand(b)
        temb = timestep_embedding(t, cfg.block_out_channels[0],
                                  flip_sin_to_cos=cfg.flip_sin_to_cos,
                                  downscale_freq_shift=cfg.freq_shift)
        temb = self.time_embedding.linear_1(temb.to(dtype))
        temb = self.time_embedding.linear_2(F.silu(temb))

        ctx = encoder_hidden_states.to(dtype)
        x = sample.to(dtype)
        if dev.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.conv_in(x)

        skips = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if len(blk.attentions):
                    x = blk.attentions[j](x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, ctx)
        x = self.mid_block.resnets[1](x, temb)

        distinct = sorted(set(cfg.block_out_channels))
        ch_hi = distinct[-1]
        ch_lo = distinct[-2] if len(distinct) > 1 else -1
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                skip = skips.pop()
                if freeu is not None and x.shape[1] in (ch_hi, ch_lo):
                    b_s, s_s = ((freeu.b1, freeu.s1) if x.shape[1] == ch_hi
                                else (freeu.b2, freeu.s2))
                    half = x.shape[1] // 2
                    x = torch.cat([x[:, :half] * b_s, x[:, half:]], dim=1)
                    skip = apply_skip_filter(skip.permute(0, 2, 3, 1), freeu,
                                             s_s).permute(0, 3, 1, 2)
                x = torch.cat([x, skip], dim=1)
                x = res(x, temb)
                if len(blk.attentions):
                    x = blk.attentions[j](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        return x.float()
