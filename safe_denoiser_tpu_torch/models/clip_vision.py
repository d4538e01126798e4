"""CLIP vision transformer: the image tower behind the evaluators.

Counterpart of ``safe_denoiser_tpu/models/clip_vision.py``, with HF
``CLIPVisionModelWithProjection`` parameter names
(``vision_model.embeddings.*``, ``vision_model.pre_layrnorm`` -- HF's
spelling --, ``vision_model.encoder.layers.N.*``,
``vision_model.post_layernorm``, ``visual_projection``). One configurable
tower covers the Q16 gate and AES (ViT-L/14), CLIPScore (ViT-B/32) and the
open_clip ViT-H/14 scorer. The encoder layers are the text encoder's,
without a mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .clip_text import CLIPEncoderLayer, CLIPTextConfig
from .layers import LayerNormFp32


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_VISION_VIT_L_14 = CLIPVisionConfig()            # Q16 / AES tower
CLIP_VISION_VIT_B_32 = CLIPVisionConfig(
    patch_size=32, hidden_size=768, num_layers=12, num_heads=12,
    intermediate_size=3072, projection_dim=512)      # CLIPScore tower
CLIP_VISION_VIT_H_14 = CLIPVisionConfig(
    hidden_size=1280, num_layers=32, num_heads=16, intermediate_size=5120,
    hidden_act="gelu", projection_dim=1024)          # open_clip coco scorer


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, n: int):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(n)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        layer_cfg = CLIPTextConfig(
            hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
            hidden_act=cfg.hidden_act, layer_norm_eps=cfg.layer_norm_eps)
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = LayerNormFp32(cfg.hidden_size,
                                          cfg.layer_norm_eps)
        self.encoder = _Encoder(layer_cfg, cfg.num_layers)
        self.post_layernorm = LayerNormFp32(cfg.hidden_size,
                                            cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """forward(pixel_values [B, 3, H, W], CLIP-normalized) ->
    (last_hidden_state [B, 1 + patches, D], pooled (the post-LN CLS
    token) [B, D], projected [B, projection_dim])."""

    def __init__(self, config: CLIPVisionConfig = CLIP_VISION_VIT_L_14):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor):
        vm = self.vision_model
        emb = vm.embeddings
        w = emb.patch_embedding.weight                         # [D, 3, p, p]
        # the stride-p convolution as one matrix product over the patches
        # (cuBLAS: no TF32 unless PyTorch's matmul switch allows it)
        b, c, h, wd = pixel_values.shape
        p = self.config.patch_size
        x = pixel_values.to(w.dtype).reshape(b, c, h // p, p, wd // p, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, -1, c * p * p)
        patches = x @ w.reshape(w.shape[0], -1).T             # [B, P, D]
        cls = emb.class_embedding.to(w.dtype).expand(
            patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x, None)
        pooled = vm.post_layernorm(x[:, 0])
        return x, pooled, self.visual_projection(pooled)


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] uint8/float in [0, 255] or [0, 1] -> CLIP-normalized
    [B, 3, size, size] f32. Values above 2 anywhere in the batch mean
    [0, 255]. A bicubic resize with antialiasing when shrinking (the JAX
    package's ``jax.image.resize(..., "bicubic")``), clipped to [0, 1]."""
    x = images.float()
    if float(x.max()) > 2.0:
        x = x / 255.0
    x = x.permute(0, 3, 1, 2)
    if tuple(x.shape[-2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bicubic",
                          align_corners=False, antialias=True)
        x = x.clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)[:, None, None]
    return (x - mean) / std
