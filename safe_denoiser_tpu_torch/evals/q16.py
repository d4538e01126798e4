"""Q16 inappropriate-content gate: a CLIP vision tower and a learned
prompt pair.

Counterpart of ``safe_denoiser_tpu/evals/q16.py``. The tower
(``models.clip_vision``) loads an HF CLIP vision state dict whose config
is read off its shapes (``infer_clip_vision_config``), goes on the device
once at construction and computes in f32; its patch embedding runs as a
matrix product, so with PyTorch's default (TF32 off for matrix products)
the f32 results hold on the GPU as on the CPU.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip_vision import (CLIP_VISION_VIT_L_14, CLIPVisionConfig,
                                  CLIPVisionModel, preprocess_clip)
from ..models.weights import clip_vision_state_dict, load_state_dict
from .clip_metrics import Q16Classifier

# head counts of the released CLIP vision towers by hidden size, the one
# field weight shapes cannot give: ViT-B (768, 12 heads), ViT-L (1024, 16),
# ViT-H (1280, 16: head dim 80, not hidden // 64), ViT-bigG (1664, 16)
_KNOWN_VISION_HEADS = {768: 12, 1024: 16, 1280: 16, 1664: 16}


def infer_clip_vision_config(sd: dict) -> CLIPVisionConfig:
    """The tower's config from a state dict's shapes (HF names, with or
    without the ``vision_model.`` prefix). ``num_heads`` comes from the
    known-towers table; an unknown hidden size takes hidden // 64 with a
    warning (pass ``vision_config`` to ``Q16Eval`` for such a tower)."""
    p = "vision_model." if any(k.startswith("vision_model.") for k in sd) \
        else ""
    patch_w = sd[f"{p}embeddings.patch_embedding.weight"]   # [H, 3, ps, ps]
    hidden, patch = int(patch_w.shape[0]), int(patch_w.shape[2])
    n_pos = sd[f"{p}embeddings.position_embedding.weight"].shape[0]
    image_size = int(round((n_pos - 1) ** 0.5)) * patch
    layer_ids = [int(k.split(".layers.")[1].split(".")[0]) for k in sd
                 if ".layers." in k]
    num_heads = _KNOWN_VISION_HEADS.get(hidden)
    if num_heads is None:
        num_heads = max(1, hidden // 64)
        warnings.warn(
            f"infer_clip_vision_config: unknown CLIP vision hidden size "
            f"{hidden} -- guessing num_heads={num_heads} by the "
            "head_dim-64 convention; pass vision_config= explicitly if "
            "this tower uses a different head count", RuntimeWarning,
            stacklevel=2)
    proj = sd.get("visual_projection.weight")
    return CLIPVisionConfig(
        image_size=image_size, patch_size=patch, hidden_size=hidden,
        num_layers=max(layer_ids) + 1, num_heads=num_heads,
        intermediate_size=int(
            sd[f"{p}encoder.layers.0.mlp.fc1.weight"].shape[0]),
        projection_dim=int(proj.shape[0]) if proj is not None
        else CLIP_VISION_VIT_L_14.projection_dim)


class Q16Eval:
    """The runners' gate for ``--category all``. Weights from
    ``clip_weights_path`` (.safetensors/.pt/.bin, config inferred unless
    ``vision_config`` is given) or an in-memory ``vision_state_dict``
    (HF names; ViT-L/14 unless ``vision_config``)."""

    def __init__(self, prompts_path: str,
                 clip_weights_path: Optional[str] = None,
                 vision_state_dict: Optional[dict] = None,
                 vision_config: Optional[CLIPVisionConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        self.classifier = Q16Classifier.from_file(prompts_path, self.device)
        cfg = vision_config or CLIP_VISION_VIT_L_14
        if vision_state_dict is not None:
            sd = vision_state_dict
        elif clip_weights_path is not None:
            sd = load_state_dict(clip_weights_path)
            if vision_config is None:
                cfg = infer_clip_vision_config(sd)
        else:
            raise ValueError("Q16Eval needs CLIP ViT-L/14 vision weights "
                             "(clip_weights_path or vision_state_dict)")
        sd = clip_vision_state_dict(sd, cfg.projection_dim)
        model = CLIPVisionModel(cfg)
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in sd.items()}, strict=True)
        self.vision_config = cfg
        self.model = model.float().to(self.device).eval()

    @torch.no_grad()
    def compute_embeddings(self, images) -> torch.Tensor:
        """Projected embeddings [N, projection_dim] of uint8 [H, W, 3]
        images (or PIL images)."""
        arr = np.stack([np.asarray(img.convert("RGB")
                                   if hasattr(img, "convert") else img)
                        for img in images])
        px = preprocess_clip(torch.as_tensor(arr, device=self.device),
                             size=self.vision_config.image_size)
        return self.model(px)[2]

    def __call__(self, samples, threshold: float = 0.6):
        """(unsafe: any sample, max similarity: a float for one sample,
        else one per sample). ``threshold`` is unused: Q16 decides by
        argmax."""
        unsafe, pred = self.classifier(self.compute_embeddings(samples))
        pred = pred.cpu().numpy()
        return (bool(unsafe.any()),
                float(pred[0]) if len(samples) == 1 else pred)

    def eval_many(self, groups, threshold: float = 0.6):
        """Several cases' sample lists in one tower pass; per group the
        result of ``__call__``."""
        flat = [img for g in groups for img in g]
        if not flat:
            return [(False, 0.0) for _ in groups]
        unsafe, pred = self.classifier(self.compute_embeddings(flat))
        unsafe, pred = unsafe.cpu().numpy(), pred.cpu().numpy()
        out, i = [], 0
        for g in groups:
            j = i + len(g)
            if not g:
                out.append((False, 0.0))
            else:
                out.append((bool(unsafe[i:j].max()),
                            float(pred[i]) if len(g) == 1 else pred[i:j]))
            i = j
        return out
