"""SD3's request in plain PyTorch float32: CLIP-L, CLIP-bigG and T5's text
states, the MMDiT loop with classifier-free guidance, the flow-match Euler
step and the repellency's renoising on its window; and the FLOPs of its
parts (``harness/flops.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import clip_text, mmdit, t5
from .repellency import repel
from .sample import latent_shape
from .schedulers import flow_match
from .tokenizer import ByteTokenizer

SAMPLERS = ("flow_match",)


def text(params, cfg: dict, texts: list, device) -> dict:
    """{"clip": the CLIP towers' penultimate states side by side, zero-padded
    to the joint width [N, 77, joint], "t5": T5's states [N, L, d_model],
    "pooled": the towers' projections [N, P]} of ``texts``."""
    tok = ByteTokenizer()
    comps = cfg["components"]

    def ids(length):
        return torch.tensor([tok.ids(t, length) for t in texts],
                            device=device)

    outs = [clip_text.forward(params(name), comps[name],
                              ids(comps[name]["max_position_embeddings"]),
                              tok.eos)
            for name in ("text_encoder", "text_encoder_2")]
    joint = comps["transformer"]["joint_attention_dim"]
    clip = torch.cat([outs[0][1], outs[1][1]], dim=-1)
    return {"clip": F.pad(clip, (0, joint - clip.shape[-1])),
            "t5": t5.forward(params("text_encoder_3"),
                             comps["text_encoder_3"],
                             ids(cfg["max_sequence_length"])),
            "pooled": torch.cat([outs[0][2], outs[1][2]], dim=-1)}


def loop(params, cfg: dict, recipe: dict, cond: dict, guidance: float,
         refs, draw, device) -> torch.Tensor:
    """Final latents from ``cond`` ([uncond, cond] rows) and the request's
    noise stream ``draw``: outside the repellency's window an Euler step,
    inside it the repelled x0 renoised to the next sigma."""
    if recipe["sampler"] not in SAMPLERS:
        raise ValueError(f"no SD3 sampler {recipe['sampler']!r}")
    rep = recipe["repellency"]
    hi, lo = rep["window"]
    ctx = torch.cat([cond["clip"], cond["t5"]], dim=1)
    pooled = cond["pooled"]
    ts, sigmas = flow_match(cfg["scheduler"], recipe["steps"])
    p_tf = params("transformer")
    lat = draw()
    for i, t in enumerate(ts.tolist()):
        s, s_next = float(sigmas[i]), float(sigmas[i + 1])
        v = mmdit.forward(p_tf, cfg["components"]["transformer"],
                          torch.cat([lat, lat]),
                          torch.full((2,), t, device=device), ctx, pooled)
        v = v[:1] + guidance * (v[1:] - v[:1])
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
    """{"encode", "step"} FLOPs of one batch: the three towers over
    2 x batch prompts, one MMDiT call at the guidance batch."""
    comps = cfg["components"]
    tf = comps["transformer"]
    b = 2 * recipe["batch"]
    lc, h, w = latent_shape(comps["vae"], recipe)
    length = cfg["max_sequence_length"]
    ids = torch.zeros(b, 77, dtype=torch.long, device="meta")
    t5_ids = torch.zeros(b, length, dtype=torch.long, device="meta")
    return {"encode": sum(count(clip_text.forward, params(n), comps[n], ids,
                                0)
                          for n in ("text_encoder", "text_encoder_2"))
            + count(t5.forward, params("text_encoder_3"),
                    comps["text_encoder_3"], t5_ids),
            "step": count(mmdit.forward, params("transformer"), tf,
                          empty(b, lc, h, w), empty(b),
                          empty(b, 77 + length, tf["joint_attention_dim"]),
                          empty(b, tf["pooled_projection_dim"]))}
