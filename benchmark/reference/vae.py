"""AutoencoderKL (diffusers) decoder, plain PyTorch in float32, and the
parameter table of the whole autoencoder (the encoder is drawn too: the
checkpoint holds it, though sampling never runs it).

Config keys are those of ``vae/config.json``: ``in_channels``,
``out_channels``, ``latent_channels``, ``block_out_channels``,
``layers_per_block``, ``norm_num_groups``, ``scaling_factor``,
``shift_factor`` (SD3), ``use_quant_conv``, ``use_post_quant_conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (Params, attention, conv, group_norm, linear, silu,
                     spec_conv, spec_linear, spec_norm)


def _has_quant_convs(cfg: dict) -> tuple:
    return (cfg.get("use_quant_conv", True),
            cfg.get("use_post_quant_conv", True))


def param_spec(cfg: dict) -> list:
    chans, per = cfg["block_out_channels"], cfg["layers_per_block"]
    lc = cfg["latent_channels"]
    out: list = []

    def resnet(name, ci, co):
        spec_norm(out, name + ".norm1", ci)
        spec_conv(out, name + ".conv1", ci, co, 3)
        spec_norm(out, name + ".norm2", co)
        spec_conv(out, name + ".conv2", co, co, 3)
        if ci != co:
            spec_conv(out, name + ".conv_shortcut", ci, co, 1)

    def mid(name, ch):
        resnet(name + ".resnets.0", ch, ch)
        a = name + ".attentions.0"
        spec_norm(out, a + ".group_norm", ch)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            spec_linear(out, f"{a}.{proj}", ch, ch)
        resnet(name + ".resnets.1", ch, ch)

    spec_conv(out, "encoder.conv_in", cfg["in_channels"], chans[0], 3)
    cin = chans[0]
    for i, ch in enumerate(chans):
        for j in range(per):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   cin if j == 0 else ch, ch)
        if i < len(chans) - 1:
            spec_conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                      ch, ch, 3)
        cin = ch
    mid("encoder.mid_block", chans[-1])
    spec_norm(out, "encoder.conv_norm_out", chans[-1])
    spec_conv(out, "encoder.conv_out", chans[-1], 2 * lc, 3)

    rev = chans[::-1]
    spec_conv(out, "decoder.conv_in", lc, rev[0], 3)
    mid("decoder.mid_block", rev[0])
    cin = rev[0]
    for i, ch in enumerate(rev):
        for j in range(per + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   cin if j == 0 else ch, ch)
        if i < len(rev) - 1:
            spec_conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv", ch,
                      ch, 3)
        cin = ch
    spec_norm(out, "decoder.conv_norm_out", rev[-1])
    spec_conv(out, "decoder.conv_out", rev[-1], cfg["out_channels"], 3)
    quant, post = _has_quant_convs(cfg)
    if quant:
        spec_conv(out, "quant_conv", 2 * lc, 2 * lc, 1)
    if post:
        spec_conv(out, "post_quant_conv", lc, lc, 1)
    return out


def _resnet(p, g, name, x):
    h = conv(p, name + ".conv1",
             silu(group_norm(p, name + ".norm1", x, g, 1e-6)), padding=1)
    h = conv(p, name + ".conv2",
             silu(group_norm(p, name + ".norm2", h, g, 1e-6)), padding=1)
    if p.has(name + ".conv_shortcut.weight"):
        x = conv(p, name + ".conv_shortcut", x)
    return x + h


def _mid(p, g, name, x):
    x = _resnet(p, g, name + ".resnets.0", x)
    a = name + ".attentions.0"
    b, c, hh, ww = x.shape
    t = group_norm(p, a + ".group_norm", x, g, 1e-6)
    t = t.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    q, k, v = (linear(p, f"{a}.{n}", t).view(b, hh * ww, 1, c)
               for n in ("to_q", "to_k", "to_v"))
    t = linear(p, a + ".to_out.0",
               attention(q, k, v, c ** -0.5, quant=p.quant).reshape(
                   b, hh * ww, c))
    x = x + t.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return _resnet(p, g, name + ".resnets.1", x)


def decode(p: Params, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """Image [B, 3, 8H, 8W] (about [-1, 1]) of latents ``z`` as the
    sampler leaves them: divided by ``scaling_factor`` and shifted by
    ``shift_factor`` here."""
    g, per = cfg["norm_num_groups"], cfg["layers_per_block"]
    z = z.float() / cfg["scaling_factor"] + cfg.get("shift_factor", 0.0)
    if _has_quant_convs(cfg)[1]:
        z = conv(p, "post_quant_conv", z)
    x = conv(p, "decoder.conv_in", z, padding=1)
    x = _mid(p, g, "decoder.mid_block", x)
    n = len(cfg["block_out_channels"])
    for i in range(n):
        for j in range(per + 1):
            x = _resnet(p, g, f"decoder.up_blocks.{i}.resnets.{j}", x)
        if i < n - 1:
            x = conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(x, scale_factor=2.0, mode="nearest"),
                     padding=1)
    x = silu(group_norm(p, "decoder.conv_norm_out", x, g, 1e-6))
    return conv(p, "decoder.conv_out", x, padding=1)


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] image -> [B, H, W, 3] uint8, as a pipeline hands it
    out: ``(x / 2 + 0.5).clamp(0, 1) * 255``, rounded."""
    x = (image.float() / 2 + 0.5).clamp(0, 1)
    return (x * 255).round().to(torch.uint8).permute(0, 2, 3, 1)
