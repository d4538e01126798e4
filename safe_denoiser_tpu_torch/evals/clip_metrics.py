"""CLIP-based evaluators: CLIPScore, Q16, AES.

Counterpart of ``safe_denoiser_tpu/evals/clip_metrics.py``:

- ``clip_score``: torchmetrics' CLIPScore, 100 max(cos(image, text), 0)
  per pair;
- ``Q16Classifier``: image embeddings against two learned prompt
  embeddings, 100 cos; argmax 1 means inappropriate;
- ``AestheticMLP``: the sac+logos+ava1-l14-linearMSE MLP over
  L2-normalized ViT-L/14 embeddings, under the original ``layers.N``
  names (its dropouts are eval-time no-ops).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
from torch import nn


def clip_score(image_embeds: torch.Tensor,
               text_embeds: torch.Tensor) -> torch.Tensor:
    """Per-pair CLIPScore of projected embeddings [N, D]."""
    a = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1,
                                                keepdim=True)
    b = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1,
                                               keepdim=True)
    return 100.0 * torch.clamp((a * b).sum(-1), min=0.0)


class Q16Classifier:
    """similarity = 100 cos(image, prompt); label 1 means inappropriate."""

    def __init__(self, prompts, device=None):
        prompts = torch.as_tensor(np.asarray(prompts, dtype=np.float32),
                                  device=device)
        if prompts.shape[0] != 2:
            raise ValueError("Q16 uses exactly two prompt embeddings, got "
                             f"{tuple(prompts.shape)}")
        self.prompts = prompts

    @classmethod
    def from_file(cls, path: str, device=None) -> "Q16Classifier":
        """The prompt pair from a ``.pt`` (``torch.load``, weights only) or
        a pickle (the reference's ``Q16_prompts.p``)."""
        if path.endswith(".pt"):
            data = torch.load(path, map_location="cpu", weights_only=True)
        else:
            with open(path, "rb") as f:
                data = pickle.load(f)
        if torch.is_tensor(data):
            data = data.float().numpy()
        return cls(data, device=device)

    def similarities(self, image_embeds: torch.Tensor) -> torch.Tensor:
        e = self.prompts / torch.linalg.vector_norm(self.prompts, dim=-1,
                                                    keepdim=True)
        x = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1,
                                                    keepdim=True)
        return 100.0 * x @ e.T                              # [N, 2]

    def __call__(self, image_embeds: torch.Tensor):
        """(unsafe [N] bool, max similarity [N])."""
        sim = self.similarities(image_embeds)
        return sim.argmax(-1) == 1, sim.max(-1).values


class AestheticMLP(nn.Module):
    """input_size -> 1024 -> 128 -> 64 -> 16 -> 1."""

    def __init__(self, input_size: int = 768):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Linear(input_size, 1024), nn.Dropout(0.2),
            nn.Linear(1024, 128), nn.Dropout(0.2),
            nn.Linear(128, 64), nn.Dropout(0.1),
            nn.Linear(64, 16), nn.Linear(16, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)[..., 0]


def convert_aes_mlp(sd) -> dict:
    """The MLP's entries (``layers.{0,2,4,6,7}``) of a torch state dict,
    as f32 tensors."""
    return {f"layers.{j}.{w}": torch.as_tensor(
        np.asarray(sd[f"layers.{j}.{w}"]), dtype=torch.float32)
        for j in (0, 2, 4, 6, 7) for w in ("weight", "bias")}


def aes_score(params: dict, image_embeds: torch.Tensor) -> torch.Tensor:
    """AES of embeddings [N, D] (L2-normalized first), on their device."""
    mlp = AestheticMLP(params["layers.0.weight"].shape[1])
    mlp.load_state_dict(params)
    mlp = mlp.to(image_embeds.device).eval()
    x = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1,
                                                keepdim=True)
    with torch.no_grad():
        return mlp(x)
