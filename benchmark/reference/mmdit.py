"""SD3 MMDiT (diffusers ``SD3Transformer2DModel``), plain PyTorch in
float32: patch embedding with the cropped 2-D sin-cos table, timestep and
pooled-text embedding, joint blocks (AdaLN-Zero, one attention over
[image ; context], tanh-GELU MLPs; the last block's context is
``context_pre_only``), AdaLN-continuous head.

Config keys are those of ``transformer/config.json``: ``sample_size``,
``patch_size``, ``in_channels``, ``out_channels``, ``num_layers``,
``num_attention_heads``, ``attention_head_dim``, ``joint_attention_dim``,
``caption_projection_dim``, ``pooled_projection_dim``,
``pos_embed_max_size``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (Params, attention, conv, layer_norm_plain, linear,
                     silu, sincos_2d, spec_conv, spec_linear,
                     timestep_embedding)


def param_spec(cfg: dict) -> list:
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    p, layers = cfg["patch_size"], cfg["num_layers"]
    out: list = []
    spec_conv(out, "pos_embed.proj", cfg["in_channels"], d, p)
    spec_linear(out, "time_text_embed.timestep_embedder.linear_1", 256, d)
    spec_linear(out, "time_text_embed.timestep_embedder.linear_2", d, d)
    spec_linear(out, "time_text_embed.text_embedder.linear_1",
                cfg["pooled_projection_dim"], d)
    spec_linear(out, "time_text_embed.text_embedder.linear_2", d, d)
    spec_linear(out, "context_embedder", cfg["joint_attention_dim"],
                cfg["caption_projection_dim"])
    for i in range(layers):
        last = i == layers - 1
        n = f"transformer_blocks.{i}"
        spec_linear(out, n + ".norm1.linear", d, 6 * d)
        spec_linear(out, n + ".norm1_context.linear", d, (2 if last else 6)
                    * d)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_out.0"):
            spec_linear(out, f"{n}.attn.{proj}", d, d)
        if not last:
            spec_linear(out, n + ".attn.to_add_out", d, d)
        for ff in ("ff",) if last else ("ff", "ff_context"):
            spec_linear(out, f"{n}.{ff}.net.0.proj", d, 4 * d)
            spec_linear(out, f"{n}.{ff}.net.2", 4 * d, d)
    spec_linear(out, "norm_out.linear", d, 2 * d)
    spec_linear(out, "proj_out", d, p * p * cfg["out_channels"])
    return out


def _mlp(p, name, x):
    return linear(p, name + ".net.2",
                  F.gelu(linear(p, name + ".net.0.proj", x),
                         approximate="tanh"))


def _block(p, cfg, i, x, c, emb):
    n = f"transformer_blocks.{i}"
    last = i == cfg["num_layers"] - 1
    heads, dh = cfg["num_attention_heads"], cfg["attention_head_dim"]
    e = silu(emb)
    sh, sc, g, sh_m, sc_m, g_m = linear(p, n + ".norm1.linear", e).chunk(6,
                                                                         -1)
    xh = layer_norm_plain(x) * (1 + sc[:, None]) + sh[:, None]
    if last:
        c_sc, c_sh = linear(p, n + ".norm1_context.linear", e).chunk(2, -1)
        ch = layer_norm_plain(c) * (1 + c_sc[:, None]) + c_sh[:, None]
    else:
        (c_sh, c_sc, c_g, c_sh_m, c_sc_m,
         c_g_m) = linear(p, n + ".norm1_context.linear", e).chunk(6, -1)
        ch = layer_norm_plain(c) * (1 + c_sc[:, None]) + c_sh[:, None]
    b, sx, sc_len = x.shape[0], x.shape[1], c.shape[1]

    def heads_of(proj, h):
        return linear(p, f"{n}.attn.{proj}", h).view(b, h.shape[1], heads,
                                                     dh)

    q = torch.cat([heads_of("to_q", xh), heads_of("add_q_proj", ch)], 1)
    k = torch.cat([heads_of("to_k", xh), heads_of("add_k_proj", ch)], 1)
    v = torch.cat([heads_of("to_v", xh), heads_of("add_v_proj", ch)], 1)
    out = attention(q, k, v, dh ** -0.5, quant=p.quant).reshape(
        b, sx + sc_len, -1)
    x = x + g[:, None] * linear(p, n + ".attn.to_out.0", out[:, :sx])
    xh = layer_norm_plain(x) * (1 + sc_m[:, None]) + sh_m[:, None]
    x = x + g_m[:, None] * _mlp(p, n + ".ff", xh)
    if last:
        return x, None
    c = c + c_g[:, None] * linear(p, n + ".attn.to_add_out", out[:, sx:])
    ch = layer_norm_plain(c) * (1 + c_sc_m[:, None]) + c_sh_m[:, None]
    return x, c + c_g_m[:, None] * _mlp(p, n + ".ff_context", ch)


def forward(p: Params, cfg: dict, sample: torch.Tensor, t: torch.Tensor,
            ctx: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Velocity [B, C, H, W] of latents ``sample`` at timesteps ``t`` [B]
    under the joint text states ``ctx`` [B, L, joint_attention_dim] and
    ``pooled`` [B, pooled_projection_dim]."""
    pz, m = cfg["patch_size"], cfg["pos_embed_max_size"]
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    b, _, h, w = sample.shape
    gh, gw = h // pz, w // pz
    x = conv(p, "pos_embed.proj", sample.float(), stride=pz)
    x = x.flatten(2).transpose(1, 2)
    table = sincos_2d(d, m, cfg["sample_size"] // pz, (m - gh) // 2,
                      (m - gw) // 2, gh, gw)
    x = x + torch.as_tensor(table, dtype=torch.float32, device=x.device)[None]
    tt = "time_text_embed."
    temb = timestep_embedding(t, 256)
    emb = (linear(p, tt + "timestep_embedder.linear_2",
                  silu(linear(p, tt + "timestep_embedder.linear_1", temb)))
           + linear(p, tt + "text_embedder.linear_2",
                    silu(linear(p, tt + "text_embedder.linear_1",
                                pooled.float()))))
    c = linear(p, "context_embedder", ctx.float())
    for i in range(cfg["num_layers"]):
        x, c = _block(p, cfg, i, x, c, emb)
    sc, sh = linear(p, "norm_out.linear", silu(emb)).chunk(2, -1)
    x = linear(p, "proj_out",
               layer_norm_plain(x) * (1 + sc[:, None]) + sh[:, None])
    co = cfg["out_channels"]
    x = x.reshape(b, gh, gw, pz, pz, co).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, co, gh * pz, gw * pz)
