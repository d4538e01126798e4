"""AutoencoderKL (SD-v1.x, and SD3's 16-channel one) with diffusers
parameter names.

Counterpart of ``safe_denoiser_tpu/models/vae.py`` in the JAX package's
default form (SDT_PALLAS_CONV=1): a bf16 resnet of the shapes the fused
conv takes (``ops.conv3x3.supports``) computes GroupNorm statistics only
(``GroupNorm32(coefs_only=True)``, the one-read kernel for the large
activations) and leaves the affine, the SiLU and the residual add to the
fused conv (``ops.conv3x3``: the kernel for CUDA tensors, its plain
version on the CPU). The fused form needs ``fast_act_ok`` (SDT_FAST_SILU
not 0), as in the JAX package. The decoder's upsamples go through
``conv3x3_up`` in the form SDT_UP_FORM names at each call (``planar``, the
default: the upsample conv kernel; ``interleave``: the interleaved one).
f32 and other shapes run the plain composition.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as c3
from ..ops.group_norm import fast_act_ok
from .layers import Attention, GroupNorm32
from .unet import cached_pack, upsample_conv


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    sample_size: int = 512
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True


SD14_VAE = VAEConfig()
SD3_VAE = VAEConfig(latent_channels=16, scaling_factor=1.5305,
                    shift_factor=0.0609, sample_size=1024,
                    use_quant_conv=False, use_post_quant_conv=False)


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(ci, co, 3, padding=1)`` that also takes the fused conv's
    seam: ``residual + conv(act(x * pre_scale + pre_shift)) + bias``, with
    the per-(batch, channel) affine applied at x's dtype. bf16 inputs of
    the shapes ``c3.supports`` takes go through ``c3.conv3x3`` on the NHWC
    view (free for a channels_last tensor), with the weights packed once
    per module on the GPU; the rest run the plain composition."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x, pre=None, act=None, residual=None):
        b, c, h, w = x.shape
        a, s = pre if pre is not None else (None, None)
        if (x.dtype == torch.bfloat16
                and c3.supports((b, h, w, c), c, self.out_channels)):
            packed = (cached_pack(self, "_fused_packed", c3.pack_weights_3x3)
                      if x.is_cuda else None)
            res = None if residual is None else residual.permute(0, 2, 3, 1)
            y = c3.conv3x3(x.permute(0, 2, 3, 1), self.weight, self.bias,
                           a, s, act, res, packed=packed)
            return y.permute(0, 3, 1, 2)
        if pre is not None:
            x = (x * a.to(x.dtype)[:, :, None, None]
                 + s.to(x.dtype)[:, :, None, None])
        if act == "silu":
            x = x * torch.sigmoid(x)
        out = super().forward(x)
        return out if residual is None else out + residual


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm32(cin, groups, 1e-6, act="silu")
        self.conv1 = Conv3x3(cin, cout)
        self.norm2 = GroupNorm32(cout, groups, 1e-6, act="silu")
        self.conv2 = Conv3x3(cout, cout)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, ci, hh, ww = x.shape
        co = self.conv1.out_channels
        shortcut = x if self.conv_shortcut is None else self.conv_shortcut(x)
        # the JAX package's fused form (models/vae.py:142-148): GroupNorm
        # statistics here, the affine+SiLU and the residual in the convs
        if (x.dtype == torch.bfloat16 and fast_act_ok(x.dtype)
                and c3.supports((b, hh, ww, ci), ci, co)
                and c3.supports((b, hh, ww, co), co, co)):
            h = self.conv1(x, pre=self.norm1(x, coefs_only=True), act="silu")
            return self.conv2(h, pre=self.norm2(h, coefs_only=True),
                              act="silu", residual=shortcut)
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        return shortcut + h


class AttnBlock(Attention):
    """Mid-block self-attention: one head over the flattened image, with
    diffusers' new-style names (group_norm, to_q, to_k, to_v, to_out.0)."""

    def __init__(self, ch: int, groups: int):
        super().__init__(ch, 1, ch, qkv_bias=True)
        self.group_norm = GroupNorm32(ch, groups, 1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = super().forward(t)
        return x + t.reshape(b, h, w, c).permute(0, 3, 1, 2)


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # diffusers pads (0, 1, 0, 1), then a stride-2 VALID conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv3x3(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_conv(self.conv, x,
                             os.environ.get("SDT_UP_FORM", "planar"))


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()


class MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, groups),
                                      ResnetBlock2D(ch, ch, groups)])
        self.attentions = nn.ModuleList([AttnBlock(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = chans[0]
        for i, ch in enumerate(chans):
            blk = _Block()
            for j in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(cin if j == 0 else ch, ch, g))
            if i < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
            self.down_blocks.append(blk)
            cin = ch
        self.mid_block = MidBlock(chans[-1], g)
        self.conv_norm_out = GroupNorm32(chans[-1], g, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = MidBlock(chans[0], g)
        self.up_blocks = nn.ModuleList()
        cin = chans[0]
        for i, ch in enumerate(chans):
            blk = _Block()
            for j in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(cin if j == 0 else ch, ch, g))
            if i < len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
            cin = ch
        self.conv_norm_out = GroupNorm32(chans[-1], g, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(chans[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        x = self.mid_block(x)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = SD14_VAE):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lc = config.latent_channels
        self.quant_conv = (nn.Conv2d(2 * lc, 2 * lc, 1)
                           if config.use_quant_conv else None)
        self.post_quant_conv = (nn.Conv2d(lc, lc, 1)
                                if config.use_post_quant_conv else None)

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.decoder.conv_in.weight.dtype)
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    def encode(self, x: torch.Tensor):
        """NCHW image in [-1, 1] -> (mean, logvar) of the latent Gaussian."""
        moments = self.encoder(self._prep(x))
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def sample_latent(self, x: torch.Tensor,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        """A draw of the latent Gaussian of image x (diffusers'
        ``latent_dist.sample()``), its noise from ``generator``."""
        mean, logvar = self.encode(x)
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = self._prep(z)
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)
