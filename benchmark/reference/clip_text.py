"""CLIP text encoder (HF transformers ``CLIPTextModel`` /
``CLIPTextModelWithProjection``), plain PyTorch in float32.

Config keys are those of ``text_encoder/config.json``: ``vocab_size``,
``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
``max_position_embeddings``, ``intermediate_size``, ``hidden_act``,
``projection_dim``, ``layer_norm_eps``; ``with_projection`` says whether
the checkpoint has ``text_projection``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (Params, attention, layer_norm, linear, spec_linear,
                     spec_norm)

_ACT = {"quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
        "gelu": F.gelu}


def param_spec(cfg: dict) -> list:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    out: list = [
        ("text_model.embeddings.token_embedding.weight",
         (cfg["vocab_size"], d), "embedding", 0),
        ("text_model.embeddings.position_embedding.weight",
         (cfg["max_position_embeddings"], d), "embedding", 0)]
    for i in range(cfg["num_hidden_layers"]):
        n = f"text_model.encoder.layers.{i}"
        spec_norm(out, n + ".layer_norm1", d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            spec_linear(out, f"{n}.self_attn.{proj}", d, d)
        spec_norm(out, n + ".layer_norm2", d)
        spec_linear(out, n + ".mlp.fc1", d, ff)
        spec_linear(out, n + ".mlp.fc2", ff, d)
    spec_norm(out, "text_model.final_layer_norm", d)
    if cfg.get("with_projection"):
        spec_linear(out, "text_projection", d, cfg["projection_dim"],
                    bias=False)
    return out


def forward(p: Params, cfg: dict, ids: torch.Tensor, eos_id: int):
    """(last hidden state after the final LayerNorm, penultimate hidden
    state, projected state at the first EOS) of token ids [B, S]."""
    b, s = ids.shape
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    act = _ACT[cfg["hidden_act"]]
    emb = "text_model.embeddings."
    x = (p.raw(emb + "token_embedding.weight")[ids]
         + p.raw(emb + "position_embedding.weight")[None, :s])
    causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
    penultimate = x
    layers = cfg["num_hidden_layers"]
    for i in range(layers):
        n = f"text_model.encoder.layers.{i}"
        if i == layers - 1:
            penultimate = x
        h = layer_norm(p, n + ".layer_norm1", x, eps)
        q, k, v = (linear(p, f"{n}.self_attn.{proj}", h).view(
            b, s, heads, d // heads) for proj in ("q_proj", "k_proj",
                                                   "v_proj"))
        att = attention(q, k, v, (d // heads) ** -0.5, mask=causal,
                        quant=p.quant)
        x = x + linear(p, n + ".self_attn.out_proj", att.reshape(b, s, d))
        h = layer_norm(p, n + ".layer_norm2", x, eps)
        x = x + linear(p, n + ".mlp.fc2", act(linear(p, n + ".mlp.fc1", h)))
    x = layer_norm(p, "text_model.final_layer_norm", x, eps)
    pooled = x[torch.arange(b, device=ids.device),
               (ids == eos_id).int().argmax(dim=-1)]
    if cfg.get("with_projection"):
        pooled = linear(p, "text_projection", pooled)
    return x, penultimate, pooled
