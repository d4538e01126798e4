"""OpenCLIP factory surface.

Counterpart of ``safe_denoiser_tpu/models/openclip_factory.py``. The
reference calls OpenCLIP only for its ViT-H-14 laion2b image-image scorer
(reference run_coco30k.py:174):

    model, _, preprocess = open_clip.create_model_and_transforms(
        "ViT-H-14", pretrained="laion2b_s32b_b79k", device=...)
    feats = model.encode_image(torch.stack([preprocess(img), ...]))

This module gives that calling convention on the port's CLIP towers
(``models/clip_vision.py``, ``models/clip_text.py``), with OpenCLIP state
dicts mapped by ``models/weights.py::open_clip_{vision,text}_state_dict``.
``pretrained`` (or ``weights_path``) is a LOCAL state-dict path: a bare
pretrained tag raises instead of downloading. The preprocess resizes with
``data/images.py::resize_bicubic`` (PIL's BICUBIC, no PIL needed).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..data.images import resize_bicubic
from ..device import ieee_f32, resolve_device
from .clip_text import CLIPTextConfig, CLIPTextModel
from .clip_vision import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD,
                          CLIP_VISION_VIT_B_32, CLIP_VISION_VIT_H_14,
                          CLIP_VISION_VIT_L_14, CLIPVisionConfig,
                          CLIPVisionModel)
from .weights import (as_tensors, load_state_dict, open_clip_text_state_dict,
                      open_clip_vision_state_dict)

# (vision cfg, text cfg) per OpenCLIP model name, as the JAX package pairs
# them: the ViT-L-14 and ViT-B-32 vision towers keep quick_gelu while their
# text towers take gelu; ViT-H-14, the one the reference runs, is gelu on
# both sides
_TEXT_VIT_H_14 = CLIPTextConfig(hidden_size=1024, num_layers=24,
                                num_heads=16, intermediate_size=4096,
                                hidden_act="gelu", projection_dim=1024)
_TEXT_VIT_L_14 = CLIPTextConfig(hidden_act="gelu")
_TEXT_VIT_B_32 = CLIPTextConfig(hidden_size=512, num_layers=12, num_heads=8,
                                intermediate_size=2048, hidden_act="gelu",
                                projection_dim=512)

MODEL_CONFIGS = {
    "ViT-H-14": (CLIP_VISION_VIT_H_14, _TEXT_VIT_H_14),
    "ViT-L-14": (CLIP_VISION_VIT_L_14, _TEXT_VIT_L_14),
    "ViT-B-32": (CLIP_VISION_VIT_B_32, _TEXT_VIT_B_32),
}


class OpenCLIPModel(nn.Module):
    """``encode_image`` / ``encode_text`` over the port's towers, in f32
    on ``device`` (cuda unless asked). A tower whose state dict is None is
    absent, and its encoder raises. Images may be NCHW (the reference
    stacks its preprocess outputs so) or NHWC, numpy or tensors."""

    def __init__(self, vision_cfg: CLIPVisionConfig,
                 text_cfg: CLIPTextConfig,
                 vision_state_dict: Optional[dict] = None,
                 text_state_dict: Optional[dict] = None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.vision_cfg, self.text_cfg = vision_cfg, text_cfg
        self.visual = self.text = None
        if vision_state_dict is not None:
            self.visual = CLIPVisionModel(vision_cfg)
            self.visual.load_state_dict(as_tensors(vision_state_dict))
        if text_state_dict is not None:
            self.text = CLIPTextModel(text_cfg, with_projection=True)
            self.text.load_state_dict(as_tensors(text_state_dict))
        self.float().to(self.device).eval()

    @torch.no_grad()
    def encode_image(self, pixel_values) -> torch.Tensor:
        """Projected embeddings [B, projection_dim] of CLIP-normalized
        images [B, 3, H, W] or [B, H, W, 3] (or one image without B)."""
        if self.visual is None:
            raise ValueError("no vision weights loaded")
        px = (pixel_values if isinstance(pixel_values, torch.Tensor)
              else torch.as_tensor(np.asarray(pixel_values)))
        px = px.to(self.device, torch.float32)
        if px.ndim == 3:
            px = px[None]
        if not (px.shape[1] == 3 and px.shape[-1] != 3):   # NHWC -> NCHW
            px = px.permute(0, 3, 1, 2)
        with ieee_f32():
            return self.visual(px)[2]

    @torch.no_grad()
    def encode_text(self, input_ids) -> torch.Tensor:
        """Projected embeddings [B, projection_dim] of token ids [B, S]."""
        if self.text is None:
            raise ValueError(
                "this checkpoint had no text tower (visual.* keys only)")
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        with ieee_f32():
            return self.text(ids)[3]


def _preprocess(image, size: int) -> np.ndarray:
    """A PIL image or uint8 array [H, W, 3] / [H, W] -> CLIP-normalized
    [3, size, size] f32 (torch's CHW, so ``np.stack`` of outputs feeds
    ``encode_image`` as the reference's ``torch.stack``): the shortest side
    to ``size`` by PIL's BICUBIC, then the centre crop (OpenCLIP's eval
    transform)."""
    if hasattr(image, "convert"):
        image = image.convert("RGB")
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (1, 3):
        raise ValueError(f"preprocess takes uint8 RGB or gray images, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    scale = size / min(w, h)
    arr = resize_bicubic(arr, (max(size, round(w * scale)),
                               max(size, round(h * scale))))
    h, w = arr.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    arr = arr[top:top + size, left:left + size]
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    x = arr.astype(np.float32) / 255.0
    x = (x - np.asarray(CLIP_IMAGE_MEAN, np.float32)) \
        / np.asarray(CLIP_IMAGE_STD, np.float32)
    return x.transpose(2, 0, 1).astype(np.float32)


def create_model_and_transforms(model_name: str,
                                pretrained: Optional[str] = None,
                                device=None,
                                weights_path: Optional[str] = None,
                                **_unused):
    """(model, preprocess_train, preprocess_val), the reference factory's
    surface (open_clip/factory.py:192). The checkpoint's ``visual.*`` keys
    give the vision tower, its ``token_embedding`` and kin the text tower
    where present."""
    if model_name not in MODEL_CONFIGS:
        raise KeyError(
            f"unknown OpenCLIP model {model_name!r}; ported names: "
            f"{sorted(MODEL_CONFIGS)} (the reference only exercises "
            f"ViT-H-14 — run_coco30k.py:174)")
    vision_cfg, text_cfg = MODEL_CONFIGS[model_name]

    path = weights_path or pretrained
    vision_sd = text_sd = None
    if path and os.path.exists(path):
        sd = load_state_dict(path)
        vision_sd = open_clip_vision_state_dict(sd, vision_cfg)
        if "token_embedding.weight" in sd:
            text_sd = open_clip_text_state_dict(sd, text_cfg)
    elif pretrained:
        raise FileNotFoundError(
            f"pretrained tag/path {pretrained!r} is not a local file; this "
            "environment has no egress — download the OpenCLIP checkpoint "
            "elsewhere and pass its path as pretrained= or weights_path=")

    model = OpenCLIPModel(vision_cfg, text_cfg, vision_sd, text_sd,
                          device=device)

    def preprocess(img):
        return _preprocess(img, vision_cfg.image_size)

    return model, preprocess, preprocess
