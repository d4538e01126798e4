"""Model FLOPs an image, counted on the benchmark's reference models on the
``meta`` device (shapes only, nothing computed) with
``torch.utils.flop_counter``: matrix products and convolutions, attention
included, elementwise work, norms and the repellency bank excluded.

The accounting is the port's ``utils/flops.py``'s: the text towers over
2 x batch prompts, ``steps`` denoiser calls at the guidance batch
2 x batch, one decode of the batch, over the batch. Each family's
reference (``reference/<family>.py``) counts its encode and step;
counting on frozen reference modules keeps the yardstick fixed whatever
the program's modules become.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import sample as ref
from ..reference import vae
from ..reference.layers import Params
from .weights import component_spec


def _meta_params(cfg: dict, name: str) -> Params:
    comp = cfg["components"][name]
    return Params({key: torch.empty(shape, device="meta")
                   for key, shape, _, _ in component_spec(name, comp)})


def _count(fn, *args) -> float:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())


def _empty(*shape) -> torch.Tensor:
    return torch.empty(*shape, device="meta")


def flops_per_image(family: str, cfg: dict, recipe: dict) -> dict:
    """{"encode", "step", "decode", "image"} FLOPs of one batch's parts
    and of one image."""
    out = ref.family(family).flop_parts(
        cfg, recipe, _count, lambda name: _meta_params(cfg, name), _empty)
    lc, h, w = ref.latent_shape(cfg["components"]["vae"], recipe)
    b = recipe["batch"]
    out["decode"] = _count(vae.decode, _meta_params(cfg, "vae"),
                           cfg["components"]["vae"], _empty(b, lc, h, w))
    out["image"] = (out["encode"] + recipe["steps"] * out["step"]
                    + out["decode"]) / b
    return out
