"""What the flow-matching pipelines share: ``FlowPipeline`` (the base of
``diffusion_sd3.SafeDiffusion3Pipeline`` and
``diffusion_flux.SafeFluxPipeline``) and the checkpoint loaders both use."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence

import numpy as np
import torch

from ..utils import profiling
from . import graph
from .diffusion import MeshModes, PendingGeneration, _StageTimer
from .sampler import RepellencyWindow


def load_component(module, path: str, fix=None):
    """``module`` with the state dict of the checkpoint directory ``path``
    (sharded safetensors included; ``fix`` maps its names first) loaded
    strictly."""
    from ..models.weights import load_sharded_state_dict
    sd = load_sharded_state_dict(path)
    sd.pop("text_model.embeddings.position_ids", None)
    module.load_state_dict(fix(sd) if fix else sd, strict=True)
    return module


def load_t5_tokenizer(path: str):
    """The T5 tokenizer of a checkpoint's tokenizer directory (SD3's
    ``tokenizer_3/``, FLUX's ``tokenizer_2/``): ``transformers``' when that
    package is installed and reads the directory, else the port's BPE
    tokenizer on it (as the JAX package). ``transformers`` is optional: the
    port does not depend on it."""
    from ..text import CLIPTokenizer
    try:
        transformers = importlib.import_module("transformers")
        return transformers.AutoTokenizer.from_pretrained(path)
    except Exception:
        return CLIPTokenizer.from_pretrained(path)


class FlowPipeline(MeshModes):
    """What the flow-matching pipelines (SD3 in ``diffusion_sd3.py``,
    FLUX in ``diffusion_flux.py``) share: the CLIP and T5 token ids, the
    repellency's window and bank as the batch's inputs, the batch's
    buffers and its ``graph.Program`` (the loop of ``_sample``, the VAE
    decode), and the entry points (``dispatch_batch`` -> ``PendingGeneration``,
    ``generate_batch``, ``dispatch``, ``__call__``). A subclass sets
    ``_family`` (the program key's tag), ``_sample`` (``sampler.sample_sd3``
    or ``sample_flux``), ``_latent_channels`` and ``_prepare_batch_embeds``
    (the text encode: (embeds, pooled) as ``_sample`` takes them). The
    mesh modes (``MeshModes``) serve SD3; FLUX's refuse."""

    _MESH_MODULES = ("transformer", "vae")
    _DATA_MESH_CONFLICT = (
        "enable_data_mesh with enable_bank_sharding is not supported: "
        "shard the bank's M axis or the served batch, not both (needs a "
        "2-D mesh)")
    _family = ""
    _sample = None
    int8_layers = 0

    def _latent_channels(self) -> int:
        raise NotImplementedError

    # -- text ---------------------------------------------------------------
    def _t5_ids(self, texts, padding="max_length", max_length=None):
        out = self.t5_tokenizer(list(texts), padding=padding,
                                max_length=max_length
                                or self.max_sequence_length,
                                truncation=True)
        return torch.tensor(np.asarray(out["input_ids"]), dtype=torch.long,
                            device=self.device)

    def _clip_ids(self, tok, text: str):
        return torch.tensor(tok([text], padding="max_length",
                                max_length=self.tokenizer.model_max_length
                                )["input_ids"],
                            dtype=torch.long, device=self.device)

    # -- generation ---------------------------------------------------------
    def _prepare_batch(self, prompts: Sequence[str], seeds: Sequence[int],
                       guidance_scales: Sequence[float],
                       num_inference_steps: int = 50,
                       height: int = 1024, width: int = 1024,
                       repellency_processor=None,
                       window: RepellencyWindow = RepellencyWindow(
                           1000.0, 780.0), mark=lambda name: None,
                       **text_kw):
        """The text encode (``_prepare_batch_embeds(prompts, **text_kw)``,
        then ``mark("encode")``) and the batch's inputs: ``(graph.Program,
        buffers)`` (``_batch_inputs``)."""
        b = len(prompts)
        if len(seeds) != b or len(guidance_scales) != b:
            raise ValueError("one seed and one guidance scale per prompt")
        with torch.no_grad(), profiling.span("sdt.dispatch.text"):
            embeds, pooled = self._prepare_batch_embeds(prompts, **text_kw)
            mark("encode")
        with profiling.span("sdt.dispatch.inputs"):
            rep_cfg, refs = None, None
            if repellency_processor is not None:
                # the reference's fast SD3 module: channel-normalized x, no
                # beta gate, and its default sigma 1.0 whatever the config
                rep_cfg = dataclasses.replace(
                    repellency_processor.config(), sigma=1.0,
                    normalize_x=True, use_beta_gate=False)
                refs = repellency_processor.get_proj_ref()
            return self._batch_inputs(embeds, pooled, seeds, guidance_scales,
                                      num_inference_steps, height, width,
                                      rep_cfg, refs, window)

    def _batch_inputs(self, embeds, pooled, seeds, guidance_scales,
                      num_inference_steps: int, height: int, width: int,
                      rep_cfg, refs, window: RepellencyWindow):
        """The sampling program of these statics and the batch's buffers:
        initial latents and the renoise draws inside the window (``graph.
        noise_slots``) from per-row generators seeded with ``seeds``, the
        embeddings, guidance scales, the bank."""
        dev = self.device
        gens = [torch.Generator(device=dev).manual_seed(int(s))
                for s in seeds]
        single = (self._latent_channels(), height // self.vae_scale_factor,
                  width // self.vae_scale_factor)

        def draw():
            return torch.stack([torch.randn(single, generator=g, device=dev)
                                for g in gens])

        # the image's tokens as 2x2 patches (FLUX's dynamic shift reads it)
        timesteps, _ = self.scheduler.timesteps_and_sigmas(
            num_inference_steps,
            image_seq_len=(single[1] // 2) * (single[2] // 2))
        in_window = [rep_cfg is not None and window.mask(i, float(t))
                     for i, t in enumerate(timesteps)]
        slots = graph.noise_slots(in_window, step_noise=False)
        latents = draw()
        bufs = {"latents": latents,
                "noise": graph.draw_noise(draw, len(slots), latents),
                "embeds": embeds.to(dev), "pooled": pooled.to(dev),
                "gs": torch.tensor(list(guidance_scales), dtype=torch.float32,
                                   device=dev)}
        if rep_cfg is not None:
            bufs.update(graph.bank_buffers(self._maybe_shard_refs(
                refs.to(device=dev, dtype=torch.float32))))
        tf, vae, sch = self.transformer, self.vae, self.scheduler
        rep_bank = self._rep_bank
        sample = type(self)._sample

        def loop(bufs, steps=None):
            noise = bufs["noise"]
            return sample(
                self._modules_on(bufs["latents"].device)[0], sch,
                bufs["embeds"], bufs["pooled"], bufs["latents"],
                lambda i, salt: noise[slots[i, salt]], num_inference_steps,
                guidance_scale=bufs["gs"], repellency=rep_cfg,
                refs=graph.bank_from(bufs), window=window, steps=steps,
                rep_bank=rep_bank)

        def decode(latents):
            vae = self._modules_on(latents.device)[1]
            vcfg = vae.config
            return vae.decode(latents / vcfg.scaling_factor
                              + vcfg.shift_factor)

        key = (self._family, id(tf), id(vae),
               tf.context_embedder.weight.dtype, self.int8_layers,
               sch.config, num_inference_steps, rep_cfg, window, rep_bank,
               graph.weights_version(tf, vae))
        return (graph.Program(key, loop, decode, graph.warm_step(in_window),
                              timesteps, self._graphable()), bufs)

    def dispatch_batch(self, prompts: Sequence[str], seeds: Sequence[int],
                       guidance_scales: Sequence[float], **kwargs
                       ) -> PendingGeneration:
        """Enqueue the text encode, the flow-match loop and the VAE decode
        for a batch (CUDA runs them asynchronously; the loop and the decode
        from CUDA graphs, ``graph.py``); ``fetch()`` on the handle waits
        and returns the images. Keywords: those of ``_prepare_batch``."""
        with _StageTimer(self.device) as timer:
            program, bufs = self._prepare_batch(
                prompts, seeds, guidance_scales, mark=timer.mark, **kwargs)
            return self._launch(program, bufs, timer)

    def generate_batch(self, prompts: Sequence[str], seeds: Sequence[int],
                       guidance_scales: Sequence[float], **kwargs):
        """Batched generation; a list of uint8 [H, W, 3] images."""
        return self.dispatch_batch(prompts, seeds, guidance_scales,
                                   **kwargs).fetch()

    def dispatch(self, prompt: str, seed: int = 42,
                 guidance_scale: float = 7.0, **kwargs):
        return self.dispatch_batch([prompt], [seed], [guidance_scale],
                                   **kwargs)

    def __call__(self, prompt: str, return_latents: bool = False, **kwargs):
        return self.dispatch(prompt, **kwargs).fetch(
            return_latents=return_latents)
