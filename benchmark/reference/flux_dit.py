"""FLUX.1 transformer (diffusers ``FluxTransformer2DModel``), plain PyTorch
in float32, from its equations:

  emb = TE(t) + GE(g) + text(pooled),  TE(t) = linear_2(silu(linear_1(
        timestep_embedding(1000 t, 256)))), GE likewise on the guidance,
        text = linear_2(silu(linear_1(pooled)));
  x = x_embedder(packed latents), c = context_embedder(T5 states);
  double block (x image, c text): (shift, scale, gate, shift_m, scale_m,
        gate_m) = norm1.linear(silu(emb)) (and norm1_context's for c);
        h = LN(x)(1 + scale) + shift; q, k, v of each stream (biased), q
        and k RMS-normed over each 128-dim head with their weights
        (eps 1e-6), joined [text ; image], rotated; one attention;
        x += gate * to_out.0(out_image), c += gate_c * to_add_out(out_text);
        x += gate_m * ff(LN(x)(1 + scale_m) + shift_m), c likewise;
  single block over s = [text ; image]: (shift, scale, gate) =
        norm.linear(silu(emb)); h = LN(s)(1 + scale) + shift; attention on
        q, k, v of h (qk-RMSNorm, rotary, no output projection);
        s += gate * proj_out([attention ; gelu_tanh(proj_mlp(h))]);
  out = proj_out(LN(s_image)(1 + scale) + shift), (scale, shift) =
        norm_out.linear(silu(emb)).

Rotary: positions (0, 0, 0) for text tokens, (0, row, col) on the image's
grid; axis i of ``axes_dims_rope`` has frequencies theta^(-2j/d_i) in
float64, cos and sin repeated pairwise and joined over the axes; x' = x cos
+ rot(x) sin, rot (a, b) -> (-b, a) pairwise. LN has no affine, eps 1e-6.

Departures from diffusers: everything in float32 (diffusers rounds the
timestep and guidance to the model's dtype before scaling them by 1000,
and its RMSNorm rounds the normalised head to the weight's dtype before the
weight); the attention in blocks of query rows (``layers.attention``).

Config keys are those of ``transformer/config.json``: ``in_channels``,
``num_layers``, ``num_single_layers``, ``num_attention_heads``,
``attention_head_dim``, ``joint_attention_dim``, ``pooled_projection_dim``,
``guidance_embeds``, ``axes_dims_rope``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (Params, attention, layer_norm_plain, linear, rms_norm,
                     silu, spec_linear, spec_norm, timestep_embedding)

THETA = 10000.0
EPS = 1e-6


def param_spec(cfg: dict) -> list:
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    dh, mlp = cfg["attention_head_dim"], 4 * d
    out: list = []
    spec_linear(out, "x_embedder", cfg["in_channels"], d)
    tt = "time_text_embed."
    embedders = ["timestep_embedder"] + (["guidance_embedder"]
                                         if cfg["guidance_embeds"] else [])
    for e in embedders:
        spec_linear(out, f"{tt}{e}.linear_1", 256, d)
        spec_linear(out, f"{tt}{e}.linear_2", d, d)
    spec_linear(out, tt + "text_embedder.linear_1",
                cfg["pooled_projection_dim"], d)
    spec_linear(out, tt + "text_embedder.linear_2", d, d)
    spec_linear(out, "context_embedder", cfg["joint_attention_dim"], d)
    for i in range(cfg["num_layers"]):
        n = f"transformer_blocks.{i}"
        spec_linear(out, n + ".norm1.linear", d, 6 * d)
        spec_linear(out, n + ".norm1_context.linear", d, 6 * d)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_out.0", "to_add_out"):
            spec_linear(out, f"{n}.attn.{proj}", d, d)
        for norm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            spec_norm(out, f"{n}.attn.{norm}", dh, bias=False)
        for ff in ("ff", "ff_context"):
            spec_linear(out, f"{n}.{ff}.net.0.proj", d, mlp)
            spec_linear(out, f"{n}.{ff}.net.2", mlp, d)
    for i in range(cfg["num_single_layers"]):
        n = f"single_transformer_blocks.{i}"
        spec_linear(out, n + ".norm.linear", d, 3 * d)
        for proj in ("to_q", "to_k", "to_v"):
            spec_linear(out, f"{n}.attn.{proj}", d, d)
        for norm in ("norm_q", "norm_k"):
            spec_norm(out, f"{n}.attn.{norm}", dh, bias=False)
        spec_linear(out, n + ".proj_mlp", d, mlp)
        spec_linear(out, n + ".proj_out", d + mlp, d)
    spec_linear(out, "norm_out.linear", d, 2 * d)
    spec_linear(out, "proj_out", d, cfg["in_channels"])
    return out


def rope(cfg: dict, txt_len: int, gh: int, gw: int, device) -> tuple:
    """(cos, sin) f32 [txt_len + gh*gw, head dim] of [text ; image]."""
    ids = np.zeros((txt_len + gh * gw, 3), np.float64)
    rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    ids[txt_len:, 1], ids[txt_len:, 2] = rows.ravel(), cols.ravel()
    cos, sin = [], []
    for i, d in enumerate(cfg["axes_dims_rope"]):
        freqs = THETA ** (-np.arange(0, d, 2, dtype=np.float64) / d)
        angles = np.outer(ids[:, i], freqs)
        cos.append(np.repeat(np.cos(angles), 2, axis=1))
        sin.append(np.repeat(np.sin(angles), 2, axis=1))
    return tuple(torch.as_tensor(np.concatenate(t, 1), dtype=torch.float32,
                                 device=device) for t in (cos, sin))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, H, D] under the rotary of tables [S, D]."""
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).flatten(-2)
    return x * cos[:, None] + rot * sin[:, None]


def _heads(p, cfg, name, h, norm):
    """The projection ``name`` of h as [B, S, H, D], RMS-normed per head
    with the norm ``norm``'s weight."""
    dh = cfg["attention_head_dim"]
    x = linear(p, name, h).unflatten(-1, (-1, dh))
    return rms_norm(p, norm, x, EPS)


def _modulate(x, shift, scale):
    return layer_norm_plain(x, EPS) * (1 + scale[:, None]) + shift[:, None]


def _attend(p, q, k, v, tables):
    cos, sin = tables
    out = attention(_rotate(q, cos, sin), _rotate(k, cos, sin), v,
                    q.shape[-1] ** -0.5, quant=p.quant)
    return out.flatten(2)


def _mlp(p, name, x):
    return linear(p, name + ".net.2",
                  F.gelu(linear(p, name + ".net.0.proj", x),
                         approximate="tanh"))


def _double(p, cfg, i, x, c, e, tables):
    n = f"transformer_blocks.{i}"
    sh, sc, g, sh_m, sc_m, g_m = linear(p, n + ".norm1.linear", e).chunk(6,
                                                                         -1)
    (c_sh, c_sc, c_g, c_sh_m, c_sc_m,
     c_g_m) = linear(p, n + ".norm1_context.linear", e).chunk(6, -1)
    xh, ch = _modulate(x, sh, sc), _modulate(c, c_sh, c_sc)
    a = n + ".attn."
    q = torch.cat([_heads(p, cfg, a + "add_q_proj", ch, a + "norm_added_q"),
                   _heads(p, cfg, a + "to_q", xh, a + "norm_q")], 1)
    k = torch.cat([_heads(p, cfg, a + "add_k_proj", ch, a + "norm_added_k"),
                   _heads(p, cfg, a + "to_k", xh, a + "norm_k")], 1)
    dh = cfg["attention_head_dim"]
    v = torch.cat([linear(p, a + "add_v_proj", ch).unflatten(-1, (-1, dh)),
                   linear(p, a + "to_v", xh).unflatten(-1, (-1, dh))], 1)
    out = _attend(p, q, k, v, tables)
    txt = c.shape[1]
    x = x + g[:, None] * linear(p, a + "to_out.0", out[:, txt:])
    c = c + c_g[:, None] * linear(p, a + "to_add_out", out[:, :txt])
    x = x + g_m[:, None] * _mlp(p, n + ".ff", _modulate(x, sh_m, sc_m))
    c = c + c_g_m[:, None] * _mlp(p, n + ".ff_context",
                                  _modulate(c, c_sh_m, c_sc_m))
    return x, c


def _single(p, cfg, i, s, e, tables):
    n = f"single_transformer_blocks.{i}"
    sh, sc, g = linear(p, n + ".norm.linear", e).chunk(3, -1)
    h = _modulate(s, sh, sc)
    a = n + ".attn."
    dh = cfg["attention_head_dim"]
    out = _attend(p, _heads(p, cfg, a + "to_q", h, a + "norm_q"),
                  _heads(p, cfg, a + "to_k", h, a + "norm_k"),
                  linear(p, a + "to_v", h).unflatten(-1, (-1, dh)), tables)
    mlp = F.gelu(linear(p, n + ".proj_mlp", h), approximate="tanh")
    return s + g[:, None] * linear(p, n + ".proj_out",
                                   torch.cat([out, mlp], -1))


def forward(p: Params, cfg: dict, packed: torch.Tensor, sigma: torch.Tensor,
            guidance: torch.Tensor, ctx: torch.Tensor, pooled: torch.Tensor,
            grid: tuple) -> torch.Tensor:
    """Velocity [B, N, in_channels] of the packed latents ``packed`` [B, N,
    in_channels] on the image grid ``grid`` (rows * cols = N) at ``sigma``
    [B] (the timestep over 1000) and ``guidance`` [B], under the T5 states
    ``ctx`` [B, L, joint_attention_dim] and CLIP's ``pooled`` [B, P]."""
    tt = "time_text_embed."

    def embedder(name, x):
        return linear(p, f"{tt}{name}.linear_2",
                      silu(linear(p, f"{tt}{name}.linear_1", x)))

    emb = embedder("timestep_embedder",
                   timestep_embedding(1000.0 * sigma.float(), 256))
    if cfg["guidance_embeds"]:
        emb = emb + embedder("guidance_embedder",
                             timestep_embedding(1000.0 * guidance.float(),
                                                256))
    emb = emb + embedder("text_embedder", pooled.float())
    e = silu(emb)
    x = linear(p, "x_embedder", packed.float())
    c = linear(p, "context_embedder", ctx.float())
    txt = c.shape[1]
    tables = rope(cfg, txt, grid[0], grid[1], x.device)
    for i in range(cfg["num_layers"]):
        x, c = _double(p, cfg, i, x, c, e, tables)
    s = torch.cat([c, x], 1)
    for i in range(cfg["num_single_layers"]):
        s = _single(p, cfg, i, s, e, tables)
    sc, sh = linear(p, "norm_out.linear", e).chunk(2, -1)
    return linear(p, "proj_out", _modulate(s[:, txt:], sh, sc))
