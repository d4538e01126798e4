"""SD-v1's request in plain PyTorch float32: CLIP's text states, the UNet
loop with classifier-free guidance, the repellency on its window and the
DDPM or DDIM step; and the FLOPs of its parts (``harness/flops.py``)."""

from __future__ import annotations

import torch

from . import clip_text, unet
from .repellency import repel
from .sample import latent_shape
from .schedulers import DDPM
from .tokenizer import ByteTokenizer

SAMPLERS = ("ddpm", "ddim")


def text(params, cfg: dict, texts: list, device) -> dict:
    """{"context": CLIP's last hidden states [N, 77, D]} of ``texts``."""
    tok = ByteTokenizer()
    tc = cfg["components"]["text_encoder"]
    ids = torch.tensor([tok.ids(t, tc["max_position_embeddings"])
                        for t in texts], device=device)
    return {"context": clip_text.forward(params("text_encoder"), tc, ids,
                                         tok.eos)[0]}


def loop(params, cfg: dict, recipe: dict, cond: dict, guidance: float,
         refs, draw, device) -> torch.Tensor:
    """Final latents from ``cond`` ([uncond, cond] rows) and the request's
    noise stream ``draw``."""
    if recipe["sampler"] not in SAMPLERS:
        raise ValueError(f"no SD-v1 sampler {recipe['sampler']!r}")
    rep = recipe["repellency"]
    hi, lo = rep["window"]
    ctx = cond["context"]
    sch = DDPM(cfg["scheduler"], recipe["sampler"], recipe["steps"])
    p_unet = params("unet")
    lat = draw()
    for t in sch.timesteps.tolist():
        eps = unet.forward(p_unet, cfg["components"]["unet"],
                           torch.cat([lat, lat]),
                           torch.full((2,), t, device=device), ctx)
        eps = eps[:1] + guidance * (eps[1:] - eps[:1])
        if lo <= t <= hi:
            x0 = repel(sch.x0(eps, t, lat), refs, rep["sigma"],
                       rep["scale"], normalize_x=False)
            lat = sch.add_noise(x0, draw(), t)
        lat = sch.step(eps, t, lat, draw())
    return lat


def flop_parts(cfg: dict, recipe: dict, count, params, empty) -> dict:
    """{"encode", "step"} FLOPs of one batch: CLIP over 2 x batch prompts,
    one UNet call at the guidance batch."""
    comps = cfg["components"]
    u, tc = comps["unet"], comps["text_encoder"]
    b = 2 * recipe["batch"]
    lc, h, w = latent_shape(comps["vae"], recipe)
    ids = torch.zeros(b, 77, dtype=torch.long, device="meta")
    return {"encode": count(clip_text.forward, params("text_encoder"), tc,
                            ids, 0),
            "step": count(unet.forward, params("unet"), u, empty(b, lc, h, w),
                          empty(b), empty(b, 77, u["cross_attention_dim"]))}

