"""Deployment bundles: the baked statics of a serving configuration.

Counterpart of ``safe_denoiser_tpu/serving/aot.py``. The JAX package
exports its three device programs (text encode, sampling scan, decode) with
``jax.export`` and serializes them. A CUDA graph cannot be written to a
file: it holds device addresses of one process. So a bundle here is a zip
holding ``meta.json`` alone -- the statics of the configuration (batch
size, steps, image size, erase spec, repellency config, SLD level, int8
state) under the JAX package's keys and values, with ``"platform":
"cuda"`` (the exporting pipeline's device type) and ``torch_version``
where JAX records ``jax_version``. Nothing in it is code.

Serving from a bundle runs the live pipeline's modules (their weights,
tokenizer and scheduler) at exactly those statics: the first ``generate``
captures the sampling loop and the decode as CUDA graphs
(``pipeline/graph.py``), later calls replay them. As in the JAX package,
weights are not part of a bundle (one bundle serves any checkpoint of the
architecture), ``load_bundle`` refuses another platform, and ``generate``
refuses what the baked statics cannot serve (another batch size, missing
or unexpected bank, another branch count, a text method that needs host
text preparation: ``generate_prepared``).
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from typing import Optional, Sequence

import torch

from ..device import resolve_device
from ..pipeline.diffusion import ERASE_SPECS, SLD_CONFIGS, GuidanceConfig
from ..pipeline.sampler import RepellencyWindow
from ..repellency.methods import RepellencyConfig


def _check_refs(meta: dict, refs) -> None:
    if (refs is None) != bool(meta.get("refs_none", True)):
        raise ValueError(
            "bundle exported with"
            + ("out" if meta.get("refs_none", True) else "")
            + " a repellency bank; call-time refs must match")


def _sd_guidance(text_method: str, safe_level: Optional[str]
                 ) -> GuidanceConfig:
    if text_method == "sld":
        return GuidanceConfig(mode="sld", **SLD_CONFIGS[safe_level])
    return GuidanceConfig()


@dataclasses.dataclass
class AotBundle:
    """An SD-v1 serving configuration's baked statics."""

    meta: dict

    def generate(self, pipe, prompts: Sequence[str], seeds: Sequence[int],
                 guidance_scales: Sequence[float],
                 negative_prompt: Optional[str] = None,
                 refs=None) -> list:
        """Batched generation at the bundle's statics on ``pipe``'s modules;
        mirrors ``generate_batch`` for 'none'-text-method erase specs
        (SAFREE's and SLD's text preparation: ``generate_prepared``).
        Returns a list of uint8 [H, W, 3] images."""
        if self.meta.get("text_method", "none") != "none":
            raise ValueError(
                f"bundle was exported for text_method "
                f"{self.meta['text_method']!r}: its SAFREE/SLD text prep is "
                "live host logic -- prepare embeddings with the live "
                "pipeline and call generate_prepared() instead")
        b = int(self.meta["batch_size"])
        if len(prompts) != b:
            raise ValueError(
                f"bundle exported for batch {b}, got {len(prompts)} prompts "
                "(pad or re-export)")
        max_length = int(self.meta["max_length"])
        with torch.no_grad():
            text = torch.cat([pipe.encode_prompt(p, negative_prompt,
                                                 max_length)
                              for p in prompts], dim=1)   # [2, B, L, D]
        use_alt = torch.zeros((int(self.meta["num_inference_steps"]), b),
                              dtype=torch.bool)
        return self.generate_prepared(pipe, text, text, use_alt, seeds,
                                      guidance_scales, refs=refs)

    def generate_prepared(self, pipe, text_embeds, text_embeds_alt, use_alt,
                          seeds: Sequence[int],
                          guidance_scales: Sequence[float],
                          refs=None) -> list:
        """Sample and decode at the bundle's statics from prepared
        embeddings (the serving path of SAFREE and SLD erase ids, whose
        text preparation runs on the live pipeline): ``text_embeds`` /
        ``text_embeds_alt`` [branches, B, L, D], ``use_alt`` [steps, B]
        bool (SAFREE's window)."""
        meta = self.meta
        branches = int(meta.get("branches", 2))
        if int(text_embeds.shape[0]) != branches:
            raise ValueError(
                f"bundle exported for {branches} guidance branches "
                f"(text_method {meta.get('text_method', 'none')!r}), "
                f"got text_embeds with {text_embeds.shape[0]}")
        b = int(meta["batch_size"])
        if len(seeds) != b:
            raise ValueError(f"bundle exported for batch {b}, got "
                             f"{len(seeds)} seeds (pad or re-export)")
        _check_refs(meta, refs)
        spec = meta["erase_spec"]
        window = RepellencyWindow(**spec["window"])
        rep_cfg = (None if refs is None or meta["repellency_cfg"] is None
                   else RepellencyConfig(**meta["repellency_cfg"]))
        safree = spec["text_method"] == "safree"
        program, bufs = pipe._batch_inputs(
            text_embeds, text_embeds_alt if safree else None,
            use_alt if safree else None, seeds, guidance_scales,
            int(meta["num_inference_steps"]), int(meta["height"]),
            int(meta["width"]),
            _sd_guidance(spec["text_method"], meta.get("safe_level")),
            rep_cfg, refs, window, None)
        return pipe._launch(program, bufs).fetch()


def export_pipeline(pipe, batch_size: int, num_inference_steps: int = 50,
                    height: int = 512, width: int = 512,
                    erase_spec=None, repellency_cfg=None, refs=None,
                    guidance=None, freeu=None,
                    safe_level: str = "STRONG") -> AotBundle:
    """The :class:`AotBundle` of a serving configuration of ``pipe``.

    ``refs``: the repellency bank; only whether there is one is baked (the
    bank stays a call-time input, its shape keys the graph). Text methods:
    'none' specs serve through :meth:`AotBundle.generate`; 'sld' bakes the
    3-branch SLD guidance of ``safe_level``'s SLD_CONFIGS row, 'safree' the
    2-branch layout with SAFREE's window as an input, both served through
    :meth:`AotBundle.generate_prepared`. The guidance follows from the
    erase spec and ``safe_level`` (the meta records nothing else): another
    ``guidance`` or a ``freeu`` is refused."""
    erase_spec = erase_spec or ERASE_SPECS["std"]
    derived = _sd_guidance(erase_spec.text_method, safe_level)
    if guidance is not None and guidance != derived:
        raise ValueError(
            f"a bundle bakes the guidance its erase spec and safe_level "
            f"give ({derived}); got {guidance}")
    if freeu is not None:
        raise ValueError("a bundle's meta records no FreeU configuration; "
                         "serve FreeU from the live pipeline")
    meta = {
        "batch_size": batch_size,
        "num_inference_steps": num_inference_steps,
        "height": height, "width": width,
        "max_length": int(pipe.tokenizer.model_max_length),
        "vae_scaling_factor": float(pipe.vae.config.scaling_factor),
        "refs_none": refs is None,
        "int8": pipe._int8_min_dim is not None,
        "int8_min_dim": pipe._int8_min_dim,
        # the baked statics: generate runs THESE whatever the serving
        # process is configured with, so runners/serve.py refuses a
        # mismatched --task_config / --erase_id
        "erase_spec": dataclasses.asdict(erase_spec),
        "repellency_cfg": (None if repellency_cfg is None
                           else dataclasses.asdict(repellency_cfg)),
        "text_method": erase_spec.text_method,
        "branches": derived.branches,
        "safe_level": (safe_level if erase_spec.text_method == "sld"
                       else None),
        "family": "sd14",
        "platform": pipe.device.type,
        "torch_version": torch.__version__,
    }
    return AotBundle(meta=meta)


@dataclasses.dataclass
class AotSd3Bundle:
    """An SD3 serving configuration's baked statics."""

    meta: dict

    def generate(self, pipe, prompts: Sequence[str], seeds: Sequence[int],
                 guidance_scales: Sequence[float],
                 negative_prompt: Optional[str] = None, refs=None) -> list:
        """Batched SD3 generation at the bundle's statics on ``pipe``'s
        modules; mirrors ``generate_batch`` without SAFREE (whose masked T5
        encodes run live: ``generate_prepared``)."""
        b = int(self.meta["batch_size"])
        if len(prompts) != b:
            raise ValueError(
                f"bundle exported for batch {b}, got {len(prompts)} prompts "
                "(pad or re-export)")
        embeds, pooled = pipe._prepare_batch_embeds(list(prompts),
                                                    negative_prompt)
        return self.generate_prepared(pipe, embeds, pooled, seeds,
                                      guidance_scales, refs=refs)

    def generate_prepared(self, pipe, embeds, pooled, seeds: Sequence[int],
                          guidance_scales: Sequence[float],
                          refs=None) -> list:
        """Sample and decode from prepared [2, B, L, D] embeddings and
        [2, B, P] pooled projections (the SAFREE serving path)."""
        meta = self.meta
        b = int(meta["batch_size"])
        if len(seeds) != b:
            raise ValueError(f"bundle exported for batch {b}, got "
                             f"{len(seeds)} seeds (pad or re-export)")
        _check_refs(meta, refs)
        rep_cfg = (None if refs is None or meta["repellency_cfg"] is None
                   else RepellencyConfig(**meta["repellency_cfg"]))
        program, bufs = pipe._batch_inputs(
            embeds, pooled, seeds, guidance_scales,
            int(meta["num_inference_steps"]), int(meta["height"]),
            int(meta["width"]), rep_cfg, refs,
            RepellencyWindow(**meta["window"]))
        return pipe._launch(program, bufs).fetch()


def export_pipeline_sd3(pipe, batch_size: int,
                        num_inference_steps: int = 50,
                        height: int = 1024, width: int = 1024,
                        repellency_cfg=None, refs=None,
                        window=None) -> AotSd3Bundle:
    """The :class:`AotSd3Bundle` of a ``SafeDiffusion3Pipeline`` serving
    configuration. ``repellency_cfg``: the processor's config; the fast
    SD3 substitutions (sigma 1.0, normalize_x, no beta gate) are applied
    here as ``dispatch_batch`` applies them live."""
    window = window or RepellencyWindow(1000.0, 780.0)
    if repellency_cfg is not None:
        repellency_cfg = dataclasses.replace(
            repellency_cfg, sigma=1.0, normalize_x=True, use_beta_gate=False)
    meta = {
        "family": "sd3",
        "batch_size": batch_size,
        "num_inference_steps": num_inference_steps,
        "height": height, "width": width,
        "clip_max_length": int(pipe.tokenizer.model_max_length),
        "t5_max_length": int(pipe.max_sequence_length),
        "vae_scaling_factor": float(pipe.vae.config.scaling_factor),
        "vae_shift_factor": float(pipe.vae.config.shift_factor),
        "refs_none": refs is None,
        "int8": pipe.int8_layers > 0,
        "repellency_cfg": (None if repellency_cfg is None
                           else dataclasses.asdict(repellency_cfg)),
        "window": dataclasses.asdict(window),
        "platform": pipe.device.type,
        "torch_version": torch.__version__,
    }
    return AotSd3Bundle(meta=meta)


def save_bundle(bundle, path: str) -> None:
    """One file: a zip holding ``meta.json``."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(bundle.meta, indent=2))


def load_bundle(path: str, device=None):
    """Read a file of :func:`save_bundle` and check its platform against
    this process's (``device``: default ``cuda``). Returns
    :class:`AotBundle` or :class:`AotSd3Bundle` by family."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    here = resolve_device(device).type
    if meta.get("platform") != here:
        raise ValueError(
            f"AOT bundle was exported for platform {meta.get('platform')!r} "
            f"but this process runs on {here!r} -- bundles are "
            "platform-locked; re-export on the target platform")
    cls = AotSd3Bundle if meta.get("family") == "sd3" else AotBundle
    return cls(meta=meta)
