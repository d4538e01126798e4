"""Offline metric runs over a sample directory: FID/KID, CLIPScore, the
image-image CLIP similarity, the style score, IS and AES.

Counterpart of ``safe_denoiser_tpu/evals/offline.py`` (reference
evaluations/fid.py:18-221 and the entry scripts
evaluate_coco30k_fid_clip.py / evaluate_copro_aes_clip.py). The towers run
in f32 without TF32 on ``device`` (cuda unless asked); the O(D^3)
``sqrtm`` of FID runs in scipy on the host (``evals/metrics.py``). Each
result is written as YAML beside the sample directory, under the JAX
package's file names and in ``yaml.dump``'s form (keys sorted), so the
files equal its. Images are read as the JAX package reads them: PNG by the
port's decoder, other formats through PIL (which the GPU machine lacks),
then PIL's BILINEAR resize where a size is asked for.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional

import numpy as np
import torch

from ..data.images import read_png, read_with_pil, resize_bilinear
from ..data.prompts import read_csv
from ..device import ieee_f32, resolve_device
from ..models.clip_vision import (CLIP_VISION_VIT_B_32, CLIP_VISION_VIT_H_14,
                                  CLIP_VISION_VIT_L_14, CLIPVisionConfig,
                                  CLIPVisionModel, preprocess_clip)
from ..models.weights import (as_tensors, clip_vision_state_dict,
                              load_state_dict, open_clip_vision_state_dict)
from ..utils.config import dump_yaml
from .clip_metrics import aes_score, convert_aes_mlp
from .inception import InceptionV3, inception_state_dict, init_random_
from .metrics import (frechet_distance, inception_score_from_logits,
                      kid_from_features, stats_from_features)


def list_images(root: str) -> list[str]:
    out: list[str] = []
    for ext in ("png", "jpg", "jpeg"):
        out += glob(os.path.join(root, f"*.{ext}"))
    return sorted(out)


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """RGB f32 [H, W, 3] in [0, 1], resized to size² when asked."""
    img = (read_png(path) if path.lower().endswith(".png")
           else read_with_pil(path))
    if size is not None:
        img = resize_bilinear(img, (size, size))
    return np.asarray(img, dtype=np.float32) / 255.0


def _stem_key(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0].split("_")[0]


def _save_yaml(sample_dir: str, name: str, result: dict) -> None:
    out = os.path.join(os.path.dirname(sample_dir.rstrip("/")), name)
    with open(out, "w") as f:
        f.write(dump_yaml(dict(sorted(result.items()))))


def _vision_tower(sd: dict, cfg: CLIPVisionConfig, device) -> CLIPVisionModel:
    model = CLIPVisionModel(cfg)
    model.load_state_dict(as_tensors(sd))
    return model.float().to(device).eval()


class InceptionFeatures:
    """Batched pool3/logits extraction with the FID InceptionV3 on
    ``device`` (cuda unless asked), f32 without TF32."""

    def __init__(self, weights_path: Optional[str] = None,
                 batch_size: int = 32, allow_random_init: bool = False,
                 device=None):
        self.device = resolve_device(device)
        model = InceptionV3()
        if weights_path is not None:
            model.load_state_dict(inception_state_dict(
                load_state_dict(weights_path)))
        elif allow_random_init:
            # plumbing-test mode only: the features mean nothing for scoring
            init_random_(model, torch.Generator().manual_seed(0))
        else:
            raise ValueError(
                "InceptionFeatures needs the pt_inception-2015-12-05 weights "
                "(weights_path) for valid FID/KID/IS numbers; pass "
                "allow_random_init=True only for plumbing tests")
        self.model = model.float().to(self.device).eval()
        self.batch_size = batch_size

    @torch.no_grad()
    def features(self, images: np.ndarray) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
        """(pool3, logits) of images [B, 299, 299, 3] in [0, 1], on the
        device."""
        with ieee_f32():
            return self.model(torch.as_tensor(images, device=self.device))

    def __call__(self, paths: list[str]) -> tuple[np.ndarray, np.ndarray]:
        feats, logits = [], []
        bs = self.batch_size
        for i in range(0, len(paths), bs):
            batch = np.stack([load_image(p, 299) for p in paths[i:i + bs]])
            f, lg = self.features(batch)
            feats.append(f.cpu().numpy())
            logits.append(lg.cpu().numpy())
        return np.concatenate(feats), np.concatenate(logits)


def evaluate_fid(sample_dir: str, dataset_root: str,
                 inception_weights: Optional[str] = None,
                 save_yaml: bool = True,
                 tag: str = "org_coco30k_10k",
                 allow_random_init: bool = False, device=None) -> dict:
    """FID + KID between sample_dir and dataset_root images (reference
    evaluations/fid.py:18-67) -> ``metrics_<tag>.yaml``."""
    extractor = InceptionFeatures(inception_weights,
                                  allow_random_init=allow_random_init,
                                  device=device)
    sample_feats, _ = extractor(list_images(sample_dir))
    ref_feats, _ = extractor(list_images(dataset_root))

    mu1, s1 = stats_from_features(sample_feats)
    mu2, s2 = stats_from_features(ref_feats)
    fid = frechet_distance(mu1, s1, mu2, s2)
    kid_mean, kid_std = kid_from_features(ref_feats, sample_feats)
    result = {"fid": float(fid), "kid": float(kid_mean),
              "log_kid": float(np.log(max(kid_mean, 1e-12)))}
    if save_yaml:
        _save_yaml(sample_dir, f"metrics_{tag}.yaml", result)
    return result


def evaluate_clip_score(sample_dir: str, prompts_csv: str,
                        clip_weights_dir: str,
                        id_column: str = "coco_id",
                        prompt_column: str = "prompt",
                        save_yaml: bool = True, device=None) -> dict:
    """CLIPScore of generated images against their prompts, matched by the
    file name's stem before its first ``_`` -> the CSV's ``id_column``
    (reference evaluations/fid.py:75-124, base_image.py:144-157) ->
    ``metrics_clip_score.yaml``."""
    from ..runners.coco30k import InLoopClipScore

    scorer = InLoopClipScore(clip_weights_dir, device=device)
    table = read_csv(prompts_csv)
    by_id = {str(row[id_column]): str(row[prompt_column])
             for _, row in table.iterrows()}

    scores = []
    for path in list_images(sample_dir):
        key = _stem_key(path)
        if key not in by_id:
            continue
        img = (load_image(path) * 255).astype(np.uint8)
        scores.append(scorer(img, by_id[key]))
    result = {"clip_score": float(np.mean(scores)), "n": len(scores)}
    if save_yaml:
        _save_yaml(sample_dir, "metrics_clip_score.yaml", result)
    return result


def evaluate_image_similarity(sample_dir: str, ref_dir: str,
                              clip_vision_weights: str,
                              tower: str = "vit_h_14",
                              openclip_layout: bool = True,
                              save_yaml: bool = True, device=None) -> dict:
    """Image-image CLIP cosine similarity, matched by file-name stem: the
    reference's ``coco_open_clip`` in-loop mode (run_coco30k.py:172-215,
    ViT-H-14 laion2b) -> ``metrics_img_sim.yaml``. The weights are an
    OpenCLIP checkpoint (``visual.*``) or, without ``openclip_layout``, an
    HF one."""
    device = resolve_device(device)
    cfg = {"vit_h_14": CLIP_VISION_VIT_H_14, "vit_l_14": CLIP_VISION_VIT_L_14,
           "vit_b_32": CLIP_VISION_VIT_B_32}[tower]
    sd = load_state_dict(clip_vision_weights)
    sd = (open_clip_vision_state_dict(sd, cfg) if openclip_layout
          else clip_vision_state_dict(sd, cfg.projection_dim))
    model = _vision_tower(sd, cfg, device)

    @torch.no_grad()
    def emb(path):
        px = preprocess_clip(torch.as_tensor(load_image(path)[None],
                                             device=device),
                             size=cfg.image_size)
        with ieee_f32():
            e = model(px)[2][0].cpu().numpy()
        return e / np.linalg.norm(e)

    refs = {_stem_key(p): p for p in list_images(ref_dir)}
    ref_embs: dict[str, np.ndarray] = {}
    sims = []
    for path in list_images(sample_dir):
        key = _stem_key(path)
        if key in refs:
            if key not in ref_embs:
                ref_embs[key] = emb(refs[key])
            sims.append(float(emb(path) @ ref_embs[key]))
    result = {"image_clip_similarity": float(np.mean(sims)), "n": len(sims)}
    if save_yaml:
        _save_yaml(sample_dir, "metrics_img_sim.yaml", result)
    return result


def style_gram_embedding(hidden_states: torch.Tensor) -> torch.Tensor:
    """Gram matrices of CLIP vision patch features, the style signature of
    reference evaluations/networks/style_CLIP.py:8: [B, S, D] ->
    [B, D, D], divided by S."""
    h = hidden_states.float()
    return torch.einsum("bsd,bse->bde", h, h) / h.shape[1]


def evaluate_style_score(sample_dir: str, target_paths: list[str],
                         clip_vision_weights: str,
                         save_yaml: bool = True, device=None) -> dict:
    """Mean negative gram distance of the samples to target style images,
    -||G_s - G_t|| / 10 (reference evaluations/base_image.py:165-179) ->
    ``metrics_style.yaml``; HF-named CLIP ViT-B/32 vision weights."""
    device = resolve_device(device)
    cfg = CLIP_VISION_VIT_B_32
    model = _vision_tower(clip_vision_state_dict(
        load_state_dict(clip_vision_weights), cfg.projection_dim), cfg,
        device)

    @torch.no_grad()
    def gram_of(path):
        px = preprocess_clip(torch.as_tensor(load_image(path)[None],
                                             device=device),
                             size=cfg.image_size)
        with ieee_f32():
            return style_gram_embedding(model(px)[0])[0].cpu().numpy()

    targets = [gram_of(p) for p in target_paths]
    sims = []
    for path in list_images(sample_dir):
        g = gram_of(path)
        for t in targets:
            diff = (g - t).reshape(-1)
            sims.append(-float(np.sqrt((diff ** 2).sum())) / 10.0)
    result = {"style_score": float(np.mean(sims)), "n": len(sims)}
    if save_yaml:
        _save_yaml(sample_dir, "metrics_style.yaml", result)
    return result


def evaluate_inception_score(sample_dir: str,
                             inception_weights: Optional[str] = None,
                             save_yaml: bool = True,
                             allow_random_init: bool = False,
                             device=None) -> dict:
    """IS over the samples (reference evaluations/utils/inception_score.py)
    -> ``metrics_is.yaml``."""
    extractor = InceptionFeatures(inception_weights,
                                  allow_random_init=allow_random_init,
                                  device=device)
    _, logits = extractor(list_images(sample_dir))
    mean, std = inception_score_from_logits(logits)
    result = {"inception_score": mean, "inception_score_std": std}
    if save_yaml:
        _save_yaml(sample_dir, "metrics_is.yaml", result)
    return result


def evaluate_aes_score(sample_dir: str, aes_weights: str,
                       clip_vision_weights: str,
                       save_yaml: bool = True, device=None) -> dict:
    """AES aesthetic score over the samples (reference
    evaluations/utils/aes.py, evaluate_copro_aes_clip.py:23-28) ->
    ``metrics_aes.yaml``; HF-named CLIP ViT-L/14 vision weights and the
    sac+logos+ava1-l14-linearMSE MLP."""
    device = resolve_device(device)
    cfg = CLIP_VISION_VIT_L_14
    model = _vision_tower(clip_vision_state_dict(
        load_state_dict(clip_vision_weights), cfg.projection_dim), cfg,
        device)
    aes_params = convert_aes_mlp(load_state_dict(aes_weights))

    embs = []
    with torch.no_grad(), ieee_f32():
        for path in list_images(sample_dir):
            px = preprocess_clip(torch.as_tensor(load_image(path)[None],
                                                 device=device),
                                 size=cfg.image_size)
            embs.append(model(px)[2])
        scores = aes_score(aes_params, torch.cat(embs)).cpu().numpy()
    result = {"aes_score": float(np.mean([float(s) for s in scores])),
              "n": len(scores)}
    if save_yaml:
        _save_yaml(sample_dir, "metrics_aes.yaml", result)
    return result
