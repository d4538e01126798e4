"""SD-v1 UNet2DConditionModel (diffusers), plain PyTorch in float32.

Config keys are those of the checkpoint's ``unet/config.json``:
``in_channels``, ``out_channels``, ``block_out_channels``,
``layers_per_block``, ``cross_attention_dim``, ``attention_head_dim`` (the
number of heads for SD-v1), ``norm_num_groups``, ``norm_eps``,
``flip_sin_to_cos``, ``freq_shift``; down blocks carry cross-attention
except the last, up blocks except the first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (Params, attention, conv, group_norm, layer_norm,
                     linear, silu, spec_conv, spec_linear, spec_norm,
                     timestep_embedding)


def _skip_channels(cfg: dict, i: int) -> list:
    """Channels of the skips up block ``i`` pops, in pop order."""
    chans, per = cfg["block_out_channels"], cfg["layers_per_block"]
    skips = [chans[0]]
    for k, ch in enumerate(chans):
        skips += [ch] * per
        if k < len(chans) - 1:
            skips.append(ch)
    popped = skips[::-1]
    return popped[i * (per + 1):(i + 1) * (per + 1)]


def _layout(cfg: dict):
    """(name, c_in, c_out, has_attention) of every resnet, down path, mid
    and up path in order, and the up/down samplers' names."""
    chans = cfg["block_out_channels"]
    n, per = len(chans), cfg["layers_per_block"]
    down, up = [], []
    cin = chans[0]
    for i, ch in enumerate(chans):
        for j in range(per):
            down.append((f"down_blocks.{i}", j, cin if j == 0 else ch, ch,
                         i < n - 1))
        cin = ch
    prev = chans[-1]
    for i, ch in enumerate(chans[::-1]):
        skips = _skip_channels(cfg, i)
        for j in range(per + 1):
            up.append((f"up_blocks.{i}", j, (prev if j == 0 else ch)
                       + skips[j], ch, i > 0))
        prev = ch
    return down, up


def param_spec(cfg: dict) -> list:
    chans = cfg["block_out_channels"]
    n, c0 = len(chans), chans[0]
    tdim, ctx = 4 * c0, cfg["cross_attention_dim"]
    out: list = []

    def resnet(name, ci, co):
        spec_norm(out, name + ".norm1", ci)
        spec_conv(out, name + ".conv1", ci, co, 3)
        spec_linear(out, name + ".time_emb_proj", tdim, co)
        spec_norm(out, name + ".norm2", co)
        spec_conv(out, name + ".conv2", co, co, 3)
        if ci != co:
            spec_conv(out, name + ".conv_shortcut", ci, co, 1)

    def transformer(name, ch):
        spec_norm(out, name + ".norm", ch)
        spec_conv(out, name + ".proj_in", ch, ch, 1)
        b = name + ".transformer_blocks.0"
        spec_norm(out, b + ".norm1", ch)
        for proj in ("to_q", "to_k", "to_v"):
            spec_linear(out, f"{b}.attn1.{proj}", ch, ch, bias=False)
        spec_linear(out, b + ".attn1.to_out.0", ch, ch)
        spec_norm(out, b + ".norm2", ch)
        spec_linear(out, b + ".attn2.to_q", ch, ch, bias=False)
        spec_linear(out, b + ".attn2.to_k", ctx, ch, bias=False)
        spec_linear(out, b + ".attn2.to_v", ctx, ch, bias=False)
        spec_linear(out, b + ".attn2.to_out.0", ch, ch)
        spec_norm(out, b + ".norm3", ch)
        spec_linear(out, b + ".ff.net.0.proj", ch, 8 * ch)
        spec_linear(out, b + ".ff.net.2", 4 * ch, ch)
        spec_conv(out, name + ".proj_out", ch, ch, 1)

    spec_conv(out, "conv_in", cfg["in_channels"], c0, 3)
    spec_linear(out, "time_embedding.linear_1", c0, tdim)
    spec_linear(out, "time_embedding.linear_2", tdim, tdim)
    down, up = _layout(cfg)
    for blk, j, ci, co, attn in down:
        resnet(f"{blk}.resnets.{j}", ci, co)
        if attn:
            transformer(f"{blk}.attentions.{j}", co)
    for i, ch in enumerate(chans[:-1]):
        spec_conv(out, f"down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
    mid = chans[-1]
    resnet("mid_block.resnets.0", mid, mid)
    transformer("mid_block.attentions.0", mid)
    resnet("mid_block.resnets.1", mid, mid)
    for blk, j, ci, co, attn in up:
        resnet(f"{blk}.resnets.{j}", ci, co)
        if attn:
            transformer(f"{blk}.attentions.{j}", co)
    for i, ch in enumerate(chans[::-1][:-1]):
        spec_conv(out, f"up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    spec_norm(out, "conv_norm_out", c0)
    spec_conv(out, "conv_out", c0, cfg["out_channels"], 3)
    return out


def _resnet(p, cfg, name, x, temb):
    g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
    h = conv(p, name + ".conv1", silu(group_norm(p, name + ".norm1", x, g,
                                                 eps)), padding=1)
    h = h + linear(p, name + ".time_emb_proj", silu(temb))[:, :, None, None]
    h = conv(p, name + ".conv2", silu(group_norm(p, name + ".norm2", h, g,
                                                 eps)), padding=1)
    if p.has(name + ".conv_shortcut.weight"):
        x = conv(p, name + ".conv_shortcut", x)
    return x + h


def _mha(p, name, x, ctx, heads):
    b, s, c = x.shape
    d = c // heads
    q = linear(p, name + ".to_q", x).view(b, s, heads, d)
    k = linear(p, name + ".to_k", ctx).view(b, ctx.shape[1], heads, d)
    v = linear(p, name + ".to_v", ctx).view(b, ctx.shape[1], heads, d)
    out = attention(q, k, v, d ** -0.5, quant=p.quant)
    return linear(p, name + ".to_out.0", out.reshape(b, s, c))


def _transformer(p, cfg, name, x, ctx):
    b, c, hh, ww = x.shape
    heads = cfg["attention_head_dim"]
    res = x
    x = conv(p, name + ".proj_in",
             group_norm(p, name + ".norm", x, cfg["norm_num_groups"], 1e-6))
    t = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    blk = name + ".transformer_blocks.0"
    h = layer_norm(p, blk + ".norm1", t, 1e-5)
    t = t + _mha(p, blk + ".attn1", h, h, heads)
    t = t + _mha(p, blk + ".attn2", layer_norm(p, blk + ".norm2", t, 1e-5),
                 ctx, heads)
    h, gate = linear(p, blk + ".ff.net.0.proj",
                     layer_norm(p, blk + ".norm3", t, 1e-5)).chunk(2, dim=-1)
    t = t + linear(p, blk + ".ff.net.2", h * F.gelu(gate))
    x = t.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return conv(p, name + ".proj_out", x) + res


def forward(p: Params, cfg: dict, sample: torch.Tensor, t: torch.Tensor,
            ctx: torch.Tensor) -> torch.Tensor:
    """eps [B, C, H, W] of latents ``sample`` at timesteps ``t`` [B] under
    text states ``ctx`` [B, L, cross_attention_dim]."""
    chans = cfg["block_out_channels"]
    per = cfg["layers_per_block"]
    temb = timestep_embedding(t, chans[0], cfg["flip_sin_to_cos"],
                              cfg["freq_shift"])
    temb = linear(p, "time_embedding.linear_2",
                  silu(linear(p, "time_embedding.linear_1", temb)))
    x = conv(p, "conv_in", sample.float(), padding=1)
    skips = [x]
    for i in range(len(chans)):
        for j in range(per):
            x = _resnet(p, cfg, f"down_blocks.{i}.resnets.{j}", x, temb)
            if i < len(chans) - 1:
                x = _transformer(p, cfg, f"down_blocks.{i}.attentions.{j}",
                                 x, ctx)
            skips.append(x)
        if i < len(chans) - 1:
            x = conv(p, f"down_blocks.{i}.downsamplers.0.conv", x, stride=2,
                     padding=1)
            skips.append(x)
    x = _resnet(p, cfg, "mid_block.resnets.0", x, temb)
    x = _transformer(p, cfg, "mid_block.attentions.0", x, ctx)
    x = _resnet(p, cfg, "mid_block.resnets.1", x, temb)
    for i in range(len(chans)):
        for j in range(per + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = _resnet(p, cfg, f"up_blocks.{i}.resnets.{j}", x, temb)
            if i > 0:
                x = _transformer(p, cfg, f"up_blocks.{i}.attentions.{j}", x,
                                 ctx)
        if i < len(chans) - 1:
            x = conv(p, f"up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(x, scale_factor=2.0, mode="nearest"),
                     padding=1)
    x = silu(group_norm(p, "conv_norm_out", x, cfg["norm_num_groups"],
                        cfg["norm_eps"]))
    return conv(p, "conv_out", x, padding=1)
