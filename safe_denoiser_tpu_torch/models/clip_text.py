"""CLIP text encoder with HF transformers parameter names.

Counterpart of ``safe_denoiser_tpu/models/clip_text.py`` (CLIP ViT-L/14 for
SD-v1.4 and SD3's first tower, OpenCLIP bigG for SD3's second): pre-LN
encoder layers with causal self-attention, final LN, EOS pooling.
State-dict keys are HF ``CLIPTextModel``'s (``text_model.*``);
``text_projection`` exists only when the config asks for it (SD-v1's
encoder has none, and ``projected`` then equals ``pooled``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .layers import LayerNormFp32, dot_product_attention


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5


CLIP_VIT_L_14 = CLIPTextConfig()   # SD-v1.4 / SD3 text_encoder
CLIP_BIG_G = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                            intermediate_size=5120, hidden_act="gelu",
                            projection_dim=1280)   # SD3 text_encoder_2

ACT2FN = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": lambda x: nn.functional.gelu(x),
    "gelu_new": lambda x: nn.functional.gelu(x, approximate="tanh"),
}


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        shape = (b, s, self.num_heads, d // self.num_heads)
        out = dot_product_attention(self.q_proj(x).view(shape),
                                    self.k_proj(x).view(shape),
                                    self.v_proj(x).view(shape), mask=mask)
        return self.out_proj(out.reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNormFp32(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNormFp32(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNormFp32(cfg.hidden_size,
                                              cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """forward(input_ids [B, S]) -> (last_hidden_state, penultimate hidden
    state, pooled at the first EOS token, projected)."""

    def __init__(self, config: CLIPTextConfig = CLIP_VIT_L_14,
                 with_projection: bool = False):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        self.text_projection = (nn.Linear(config.hidden_size,
                                          config.projection_dim, bias=False)
                                if with_projection else None)

    def forward(self, input_ids: torch.Tensor):
        cfg = self.config
        tm = self.text_model
        b, s = input_ids.shape
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :s])
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=input_ids.device).tril()[None, None]
        penultimate = None
        for i, layer in enumerate(tm.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos_pos]
        projected = (pooled if self.text_projection is None
                     else self.text_projection(pooled))
        return x, penultimate, pooled, projected
