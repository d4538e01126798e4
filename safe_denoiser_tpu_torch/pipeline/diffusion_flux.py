"""SafeFluxPipeline: the FLUX.1 (guidance-distilled, flow matching)
safe-denoiser pipeline on one device. No counterpart in the JAX package;
the safe denoiser carries over SD3's flow-match form unchanged.

  * the text: CLIP-L's pooled output (no projection) and T5-XXL's states
    at ``max_sequence_length`` (512) tokens, one prompt a row, no negative;
  * the loop (``sampler.sample_flux``): one transformer call a step at the
    batch, the guidance scale as the guidance embedding (no CFG batch),
    the 2x2-packed latents in and out; the dynamic-shift schedule at the
    image's token count; inside the repellency window x0 = x - sigma v is
    repelled (``KernelFastRepellency``, B2) and renoised on the unpacked
    [B, 16, H/8, W/8] latents, as ``diffusion_sd3.py``;
  * the 16-channel VAE decode at the VAE's ``scaling_factor`` and
    ``shift_factor`` (0.3611 and 0.1159 for FLUX.1).

Everything else is ``flow.FlowPipeline``'s: per-row generators
for the initial latents and the renoise draws, the loop and the decode
replayed from CUDA graphs on ``cuda`` (``graph.py``), the program's spans,
``dispatch_batch`` -> ``PendingGeneration.fetch``. The transformer, T5 and
the VAE compute in ``dtype`` (bf16), CLIP-L in f32. The parallel layer
does not take FLUX: ``enable_data_mesh`` and ``enable_bank_sharding``
raise, and there is no ``load_lora``.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

from ..device import resolve_device
from ..models import (AutoencoderKL, CLIPTextModel, FluxTransformer,
                      T5Encoder)
from ..schedulers.flow_match import (FlowMatchEulerScheduler,
                                     flow_match_config_from_checkpoint)
from . import graph
from .flow import FlowPipeline, load_component, load_t5_tokenizer
from .sampler import sample_flux


class SafeFluxPipeline(FlowPipeline):
    _family = "flux"
    _sample = staticmethod(sample_flux)

    def __init__(self, transformer: FluxTransformer, vae: AutoencoderKL,
                 clip_l: CLIPTextModel, t5: T5Encoder, tokenizer,
                 tokenizer_2, scheduler: FlowMatchEulerScheduler,
                 device=None, logger=None, max_sequence_length: int = 512):
        self.device = resolve_device(device)
        self.transformer = transformer.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.clip_l = clip_l.to(self.device).eval()
        self.t5 = t5.to(self.device).eval()
        self.tokenizer = tokenizer
        self.t5_tokenizer = tokenizer_2
        self.scheduler = scheduler
        self.logger = logger
        self.max_sequence_length = max_sequence_length
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self._graphs = graph.GraphSlot()

    @classmethod
    def from_pretrained(cls, model_dir: str, device=None,
                        dtype: torch.dtype = torch.bfloat16, logger=None):
        """Load an HF-layout FLUX.1 checkpoint dir (transformer/ vae/
        text_encoder/ (CLIP-L) text_encoder_2/ (T5) tokenizer/
        tokenizer_2/ scheduler/), sharded safetensors included."""
        from ..models.weights import load_component_config, t5_state_dict
        from ..text import CLIPTokenizer

        def sub(name):
            return os.path.join(model_dir, name)

        tf = load_component(FluxTransformer(load_component_config(
            sub("transformer"), "flux")), sub("transformer"))
        vae = load_component(AutoencoderKL(load_component_config(
            sub("vae"), "vae")), sub("vae"))
        clip = load_component(CLIPTextModel(load_component_config(
            sub("text_encoder"), "clip_text"), with_projection=False),
            sub("text_encoder"))
        t5 = load_component(T5Encoder(load_component_config(
            sub("text_encoder_2"), "t5")), sub("text_encoder_2"),
            t5_state_dict)
        sched = FlowMatchEulerScheduler(
            flow_match_config_from_checkpoint(sub("scheduler")))
        return cls(tf.to(dtype), vae.to(dtype), clip, t5.to(dtype),
                   CLIPTokenizer.from_pretrained(sub("tokenizer")),
                   load_t5_tokenizer(sub("tokenizer_2")), sched,
                   device=resolve_device(device), logger=logger)

    def _latent_channels(self) -> int:
        return self.vae.config.latent_channels

    # -- text ---------------------------------------------------------------
    @torch.no_grad()
    def encode_prompt(self, prompt: str):
        """(T5 states [1, L, 4096], CLIP-L's pooled output [1, 768]) of one
        prompt."""
        pooled = self.clip_l(self._clip_ids(self.tokenizer, prompt))[2]
        return self.t5(self._t5_ids([prompt])), pooled

    def _prepare_batch_embeds(self, prompts: Sequence[str]):
        """(embeds [B, L, 4096], pooled [B, 768]), one prompt a row."""
        per = [self.encode_prompt(p) for p in prompts]
        return (torch.cat([e for e, _ in per]),
                torch.cat([p for _, p in per]))

    def _prepare_batch(self, prompts, seeds, guidance_scales,
                       num_inference_steps: int = 28, **kwargs):
        """``FlowPipeline._prepare_batch`` at FLUX.1-dev's 28 steps by
        default; ``guidance_scales`` are the guidance embedding's values."""
        return super()._prepare_batch(prompts, seeds, guidance_scales,
                                      num_inference_steps, **kwargs)

    def dispatch(self, prompt: str, seed: int = 42,
                 guidance_scale: float = 3.5, **kwargs):
        return super().dispatch(prompt, seed, guidance_scale, **kwargs)

    def enable_data_mesh(self, *args, **kwargs):
        raise NotImplementedError("the parallel layer does not take FLUX")

    enable_bank_sharding = enable_data_mesh
