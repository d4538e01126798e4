"""The comparison that decides ``correct``: a sample, drawn from the seed,
of the requests the window served, run again by the plain reference
(``reference/``) from the same seed's checkpoint, bank, prompts, seeds and
guidance, once the program's state is freed.

Numbers, each the widest over the sample:
  image_rel_rms   rms(program - reference) / rms(reference - its mean),
                  over the uint8 images as served, the reference run from
                  the prompt;
  image_mean_abs  mean |program - reference| in levels of 255, the same;
  latent_rel_rms  image_rel_rms's measure over the final latents, where the
                  load keeps them (the batch mixes);
  encode_rel_rms  the same over the program's text states of the sampled
                  prompts (its encoder called again after the window; each
                  tensor of the family's ``text``, the widest) against the
                  reference towers': the encode stage alone;
  decode_rel_rms  image_rel_rms of the program's image against the
                  reference decoder run on the program's own final latents:
                  the decode stage alone.
The cell's limits file names the numbers compared and their limits; the
reference computes only what those need.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..reference import sample as ref
from ..reference.layers import ieee_f32
from . import traffic as gen

# the reference's work that each number needs
NEEDS = {"image_rel_rms": "sample", "image_mean_abs": "sample",
         "latent_rel_rms": "sample", "encode_rel_rms": "text",
         "decode_rel_rms": "decode"}


class Served(NamedTuple):
    """A request as the window served it: its uint8 image [H, W, 3], its
    final latents (None where the load does not keep them) and its row in
    the batch that served it."""
    request: object
    image: object
    latents: object
    row: int


def _rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    got, want = got.astype(np.float64), want.astype(np.float64)
    spread = np.sqrt(np.mean((want - want.mean()) ** 2))
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(spread, 1e-12))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def pick(served: list, seed: int, n: int) -> list:
    """``n`` of the served entries, drawn from the seed and spread over the
    rows of the batches: row 0, 1, ... in turn, each a random entry of
    that row, so that every row is checked once ``n`` reaches the batch."""
    rng = gen.rng_for(seed, "check")
    rows = sorted({s.row for s in served})
    left = {r: [int(i) for i in rng.permutation(
        [i for i, s in enumerate(served) if s.row == r])] for r in rows}
    chosen: list = []
    n = min(n, len(served))
    while len(chosen) < n:
        for r in rows:
            if left[r] and len(chosen) < n:
                chosen.append(left[r].pop(0))
    return [served[i] for i in sorted(chosen)]


def needs_of(names) -> set:
    unknown = set(names) - set(NEEDS)
    if unknown:
        raise ValueError(f"no number {sorted(unknown)}; known: "
                         f"{sorted(NEEDS)}")
    return {NEEDS[n] for n in names}


def reference_outputs(family: str, tensors: dict, cfg: dict, recipe: dict,
                      bank, request, latents, needs: set, device) -> dict:
    """What the exact reference gives for one request under ``needs``:
    "text", "latents" and "image" from the prompt, "decoded" from the
    program's final ``latents``."""
    out: dict = {}
    if needs & {"text", "sample"}:
        out["text"] = ref.text(family, tensors, cfg, recipe, request.prompt,
                               None, device)
    if "sample" in needs:
        out["latents"] = ref.loop(family, tensors, cfg, recipe, out["text"],
                                  request.seed, request.guidance, bank,
                                  None, device)
        out["image"] = ref.decode(tensors, cfg, out["latents"])
    if "decode" in needs and latents is not None:
        out["decoded"] = ref.decode(
            tensors, cfg, torch.as_tensor(latents)[None].to(
                device=device, dtype=torch.float32))
    return out


def numbers(sample: list, refs: list, texts: list) -> dict:
    """The numbers over ``sample`` [Served] against ``refs`` (each
    ``reference_outputs``), ``texts`` the program's text states of each
    (or None): each the widest over the sample."""
    found: dict = {}

    def add(name, value):
        found[name] = max(found.get(name, value), value)

    for s, want, text in zip(sample, refs, texts):
        image = _np(s.image)
        if "image" in want:
            ref_img = _np(want["image"][0])
            add("image_rel_rms", _rel_rms(image, ref_img))
            add("image_mean_abs", float(np.mean(np.abs(image - ref_img))))
            if s.latents is not None:
                add("latent_rel_rms", _rel_rms(_np(s.latents),
                                               _np(want["latents"][0])))
        if "decoded" in want:
            add("decode_rel_rms", _rel_rms(image, _np(want["decoded"][0])))
        if "text" in want and text is not None:
            add("encode_rel_rms", max(_rel_rms(_np(text[k]),
                                               _np(want["text"][k]))
                                      for k in want["text"]))
    return found


def compare(load, system, limits: dict, seed: int) -> tuple:
    """(correct, {name: {"value", "limit"}} of the compared numbers, every
    number read). Takes the program's text states of the sample, then
    releases the program before the reference runs."""
    needs = needs_of(limits["numbers"])
    sample = pick(load.served(), seed, limits["sample"])
    texts = [system.program_text(s.request) if "text" in needs else None
             for s in sample]
    load.release()
    if not sample:
        return False, {}, {}
    with torch.no_grad(), ieee_f32():
        refs = system.reference(sample, needs)
    found = numbers(sample, refs, texts)
    compared = {name: {"value": found.get(name, float("nan")),
                       "limit": float(spec["limit"])}
                for name, spec in limits["numbers"].items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared, found
