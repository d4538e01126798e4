"""FLUX.1's request in plain PyTorch float32: CLIP-L's pooled output and
T5's states, the guidance-distilled transformer loop (no CFG) on 2x2-packed
latents under the dynamic-shift flow-match schedule, the Euler step and the
repellency's renoising on its window in the unpacked latent space; and the
FLOPs of its parts (``harness/flops.py``).

FLUX takes no negative prompt: ``text`` encodes the last text it is given
(the request's prompt) alone.
"""

from __future__ import annotations

import numpy as np
import torch

from . import clip_text, flux_dit, t5
from .repellency import repel
from .sample import latent_shape
from .tokenizer import ByteTokenizer

SAMPLERS = ("flow_match",)


def schedule(cfg: dict, steps: int, image_seq_len: int):
    """(timesteps [steps], sigmas [steps + 1] ending in 0) in float64 of
    diffusers' ``FluxPipeline``: sigmas linspace(1, 1/steps, steps) under
    the exponential time shift e^mu / (e^mu + 1/sigma - 1), mu linear in
    the image's token count through (base_image_seq_len, base_shift) and
    (max_image_seq_len, max_shift); timesteps num_train_timesteps x
    sigma."""
    slope = (cfg["max_shift"] - cfg["base_shift"]) / (
        cfg["max_image_seq_len"] - cfg["base_image_seq_len"])
    mu = cfg["base_shift"] + slope * (image_seq_len
                                      - cfg["base_image_seq_len"])
    sigmas = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
    return (sigmas * cfg["num_train_timesteps"],
            np.concatenate([sigmas, [0.0]]))


def pack(lat: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/2)(W/2), 4C], a patch's values ordered
    (channel, row, column)."""
    b, c, h, w = lat.shape
    return lat.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c4 = x.shape
    return x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(
        0, 3, 1, 4, 2, 5).reshape(b, c4 // 4, h, w)


def text(params, cfg: dict, texts: list, device) -> dict:
    """{"t5": T5's states [1, L, d_model] padded to max_sequence_length,
    "pooled": CLIP-L's pooled output [1, hidden] (no projection)} of the
    last of ``texts``."""
    tok = ByteTokenizer()
    comps = cfg["components"]

    def ids(length):
        return torch.tensor([tok.ids(texts[-1], length)], device=device)

    clip = comps["text_encoder"]
    _, _, pooled = clip_text.forward(params("text_encoder"), clip,
                                     ids(clip["max_position_embeddings"]),
                                     tok.eos)
    return {"t5": t5.forward(params("text_encoder_2"),
                             comps["text_encoder_2"],
                             ids(cfg["max_sequence_length"])),
            "pooled": pooled}


def loop(params, cfg: dict, recipe: dict, cond: dict, guidance: float,
         refs, draw, device) -> torch.Tensor:
    """Final latents [1, C, h, w] from ``cond`` and the request's noise
    stream ``draw``: outside the repellency's window an Euler step, inside
    it the repelled x0 renoised to the next sigma."""
    if recipe["sampler"] not in SAMPLERS:
        raise ValueError(f"no FLUX sampler {recipe['sampler']!r}")
    rep = recipe["repellency"]
    hi, lo = rep["window"]
    tf = cfg["components"]["transformer"]
    p_tf = params("transformer")
    lat = draw()
    _, _, h, w = lat.shape
    grid = (h // 2, w // 2)
    ts, sigmas = schedule(cfg["scheduler"], recipe["steps"],
                          grid[0] * grid[1])
    g = torch.full((1,), guidance, device=device)
    for i, t in enumerate(ts.tolist()):
        s, s_next = float(sigmas[i]), float(sigmas[i + 1])
        v = unpack(flux_dit.forward(
            p_tf, tf, pack(lat), torch.full((1,), s, device=device), g,
            cond["t5"], cond["pooled"], grid), h, w)
        if not lo <= float(np.float32(t)) <= hi:
            lat = lat + (s_next - s) * v
            continue
        x0 = repel(lat - s * v, refs, rep["sigma"], rep["scale"],
                   normalize_x=True)
        noise = s_next ** 0.5 * (lat + (1 - s) * v) \
            + (1 - s_next) ** 0.5 * draw()
        lat = x0 + s_next * (noise - x0)
    return lat


def flop_parts(cfg: dict, recipe: dict, count, params, empty) -> dict:
    """{"encode", "step"} FLOPs of one batch: CLIP-L and T5 over batch
    prompts, one transformer call at the batch (no CFG)."""
    comps = cfg["components"]
    tf = comps["transformer"]
    b = recipe["batch"]
    lc, h, w = latent_shape(comps["vae"], recipe)
    n = (h // 2) * (w // 2)
    length = cfg["max_sequence_length"]
    clip = comps["text_encoder"]
    ids = torch.zeros(b, clip["max_position_embeddings"], dtype=torch.long,
                      device="meta")
    t5_ids = torch.zeros(b, length, dtype=torch.long, device="meta")
    return {"encode": count(clip_text.forward, params("text_encoder"), clip,
                            ids, 0)
            + count(t5.forward, params("text_encoder_2"),
                    comps["text_encoder_2"], t5_ids),
            "step": count(flux_dit.forward, params("transformer"), tf,
                          empty(b, n, 4 * lc), empty(b), empty(b),
                          empty(b, length, tf["joint_attention_dim"]),
                          empty(b, tf["pooled_projection_dim"]),
                          (h // 2, w // 2))}
