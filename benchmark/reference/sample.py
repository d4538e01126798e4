"""One request, end to end, in plain PyTorch float32: the text towers, the
sampling loop with classifier-free guidance and the safe denoiser's
repellency on its window, the scheduler's step and the VAE decode.

Each model family's stages are in ``reference/<family>.py``: ``text``
(the towers' states of [negative prompt, prompt] as a dict of tensors),
``loop`` (the final latents from those states) and ``flop_parts``.

A request's noise is drawn as the pipelines define it: one
``torch.Generator`` on the device seeded with the request's seed gives the
initial latents, then step by step the repellency's renoise (inside the
window) and, for SD-v1's samplers, the step's noise, each of the latents'
shape. ``tensors`` maps a component ("unet", "vae", "text_encoder", ...)
to its checkpoint's tensors by name; ``recipe`` is the traffic mix's
sampling recipe.
"""

from __future__ import annotations

import importlib

import torch

from . import vae
from .layers import Params
from .repellency import channel_normalize

# what the reference implements of a recipe's repellency
METHODS = ("kernel_fast",)


def latent_shape(vae_cfg: dict, recipe: dict) -> tuple:
    """(C, h, w) of one request's latents: the image over the VAE's
    downscale factor."""
    f = 2 ** (len(vae_cfg["block_out_channels"]) - 1)
    return (vae_cfg["latent_channels"], recipe["height"] // f,
            recipe["width"] // f)


def family(name: str):
    """The reference's stages of a model family (``reference/<name>.py``)."""
    try:
        return importlib.import_module(f"benchmark.reference.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"benchmark.reference.{name}":
            raise
        raise ValueError(f"no reference for family {name!r}") from e


def check_recipe(recipe: dict) -> None:
    """Refuse a repellency the reference does not implement: any method
    but kernel_fast, or the beta gate on."""
    rep = recipe["repellency"]
    if rep["method"] not in METHODS or rep["beta_gate"]:
        raise ValueError(f"the reference implements {METHODS} with the beta "
                         f"gate off, not {rep['method']!r} with beta_gate="
                         f"{rep['beta_gate']!r}")


def params_of(tensors: dict, quant):
    """``params(component)``: its tensors; ``quant`` rounds them and the
    component's product inputs: one callable for every component, or a
    dict of them by component (None: exact)."""
    def params(name: str) -> Params:
        q = quant.get(name) if isinstance(quant, dict) else quant
        return Params(tensors[name], q)
    return params


def text(fam: str, tensors: dict, cfg: dict, recipe: dict, prompt: str,
         quant=None, device="cuda") -> dict:
    """The towers' states of [the recipe's negative prompt, ``prompt``]."""
    with torch.no_grad():
        return family(fam).text(params_of(tensors, quant), cfg,
                                [recipe.get("negative_prompt", ""), prompt],
                                device)


def loop(fam: str, tensors: dict, cfg: dict, recipe: dict, cond: dict,
         seed: int, guidance: float, bank: torch.Tensor, quant=None,
         device="cuda") -> torch.Tensor:
    """Final latents [1, C, h, w] of one request from the text states
    ``cond``; ``bank`` is the raw negative bank [M, C, h, w] (normalized
    over channels here)."""
    check_recipe(recipe)
    refs = channel_normalize(bank.float())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = latent_shape(cfg["components"]["vae"], recipe)

    def draw():
        return torch.randn(shape, generator=gen, device=device)[None]

    with torch.no_grad():
        return family(fam).loop(params_of(tensors, quant), cfg, recipe,
                                cond, guidance, refs, draw, device)


def sample(fam: str, tensors: dict, cfg: dict, recipe: dict, prompt: str,
           seed: int, guidance: float, bank: torch.Tensor, quant=None,
           device="cuda"):
    """(final latents [1, C, h, w], image uint8 [1, H, W, 3]) of one
    request, every stage from the prompt."""
    cond = text(fam, tensors, cfg, recipe, prompt, quant, device)
    lat = loop(fam, tensors, cfg, recipe, cond, seed, guidance, bank, quant,
               device)
    return lat, decode(tensors, cfg, lat, quant)


def decode(tensors: dict, cfg: dict, latents: torch.Tensor, quant=None
           ) -> torch.Tensor:
    """uint8 image [N, H, W, 3] of final latents [N, C, h, w] through the
    reference decoder alone (the decode stage's check)."""
    with torch.no_grad():
        image = vae.decode(params_of(tensors, quant)("vae"),
                           cfg["components"]["vae"], latents)
    return vae.to_uint8(image)
