"""SafeDiffusionPipeline: tokenizer, CLIP text encoder, UNet, VAE and DDPM
scheduler on one device, with the safe-denoiser repellency hook.

Counterpart of ``safe_denoiser_tpu/pipeline/diffusion.py`` for the plain
text path (``std``, ``esd``) and their repellency erase ids, with the
bank's VAE embedding, the ESD UNet swap and W8A8 int8 on the UNet's wide
transformer blocks (``enable_int8``). SAFREE, the SLD text branch, FreeU,
LoRA and the device mesh are not ported yet: the keywords that ask for
them raise ``NotImplementedError``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise. Each prompt row draws
its initial latents and its per-step noise from its own
``torch.Generator`` seeded with the row's seed, so a row's result does not
depend on the rest of the batch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models import AutoencoderKL, CLIPTextModel, UNet2DConditionModel
from ..schedulers import DDPMConfig, DDPMScheduler
from .sampler import GuidanceConfig, RepellencyWindow, sample_sd


@dataclasses.dataclass(frozen=True)
class EraseSpec:
    """Text-safety method x repellency gating of one erase id."""

    text_method: str = "none"         # only 'none' in this port so far
    repellency: bool = False
    window: RepellencyWindow = RepellencyWindow()


# the erase ids whose text path is the plain one ('esd' swaps in a
# fine-tuned UNet checkpoint; its sampling is 'std')
ERASE_SPECS: dict[str, EraseSpec] = {
    "std": EraseSpec(),
    "esd": EraseSpec(),
    "std_rep": EraseSpec(repellency=True,
                         window=RepellencyWindow(1000.0, 800.0)),
    "esd_rep": EraseSpec(repellency=True,
                         window=RepellencyWindow(1000.0, 780.0)),
}


def _ddpm_config_from_checkpoint(scheduler_dir: str) -> DDPMConfig:
    """DDPMConfig from a checkpoint's scheduler_config.json."""
    path = os.path.join(scheduler_dir, "scheduler_config.json")
    if not os.path.exists(path):
        return DDPMConfig()
    with open(path) as f:
        cfg = json.load(f)
    return DDPMConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        clip_sample=cfg.get("clip_sample", False),
        prediction_type=cfg.get("prediction_type", "epsilon"),
        variance_type=cfg.get("variance_type", "fixed_small"),
        timestep_spacing=cfg.get("timestep_spacing", "leading"),
        steps_offset=cfg.get("steps_offset", 1))


def postprocess_image_host(image: torch.Tensor) -> torch.Tensor:
    """``(x/2 + 0.5).clip(0, 1)`` on the host, computed in f32 and returned
    in the image's dtype."""
    raw = image.detach().cpu()
    return (raw.float() / 2 + 0.5).clamp(0, 1).to(raw.dtype)


class SafeDiffusionPipeline:
    def __init__(self, unet: UNet2DConditionModel, vae: AutoencoderKL,
                 text_encoder: CLIPTextModel, tokenizer, scheduler,
                 device=None, logger=None):
        self.device = resolve_device(device)
        self.unet = unet.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.text_encoder = text_encoder.to(self.device).eval()
        self.tokenizer = tokenizer
        self.scheduler = scheduler
        self.logger = logger
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self._uncond_memo = None
        self._int8_min_dim = None
        self.int8_layers = 0

    @classmethod
    def from_pretrained(cls, model_dir: str, scheduler=None, device=None,
                        dtype: torch.dtype = torch.bfloat16, logger=None):
        """Load an HF-layout SD checkpoint dir (unet/ vae/ text_encoder/
        tokenizer/ scheduler/). The UNet and VAE compute in ``dtype``
        (bf16, as the JAX package), the text encoder in f32."""
        from ..models.weights import load_component_config, \
            load_sharded_state_dict
        from ..text import CLIPTokenizer

        device = resolve_device(device)

        def load(module, sub):
            sd = load_sharded_state_dict(os.path.join(model_dir, sub))
            # a constant buffer older transformers versions saved
            sd.pop("text_model.embeddings.position_ids", None)
            module.load_state_dict(sd, strict=True)
            return module

        unet = load(UNet2DConditionModel(load_component_config(
            os.path.join(model_dir, "unet"), "unet")), "unet")
        vae = load(AutoencoderKL(load_component_config(
            os.path.join(model_dir, "vae"), "vae")), "vae")
        text_cfg = load_component_config(
            os.path.join(model_dir, "text_encoder"), "clip_text")
        text_sd = load_sharded_state_dict(
            os.path.join(model_dir, "text_encoder"))
        text = load(CLIPTextModel(text_cfg, "text_projection.weight"
                                  in text_sd), "text_encoder")
        tokenizer = CLIPTokenizer.from_pretrained(
            os.path.join(model_dir, "tokenizer"))
        if scheduler is None:
            scheduler = DDPMScheduler(_ddpm_config_from_checkpoint(
                os.path.join(model_dir, "scheduler")))
        return cls(unet.to(dtype), vae.to(dtype), text, tokenizer, scheduler,
                   device=device, logger=logger)

    def load_unet_state_dict(self, path: str) -> None:
        """Swap in a fine-tuned UNet (ESD: a diffusers-named state dict in a
        .safetensors/.pt/.bin file, possibly under a ``unet`` key)."""
        from ..models.weights import load_state_dict
        sd = load_state_dict(path)
        if isinstance(sd.get("unet"), dict):
            sd = sd["unet"]
        self.unet.load_state_dict(sd, strict=True)

    def enable_int8(self, min_dim: int = 1280) -> int:
        """W8A8 int8 on the UNet's transformer-block linears with
        min(N, K) >= ``min_dim`` (``ops.quant.quantize_unet_params``):
        weights quantized once here, activations per token at each call.
        Idempotent for one ``min_dim``; another raises (the scales are
        fixed). Returns the number of quantized linears."""
        if self._int8_min_dim is not None:
            if min_dim != self._int8_min_dim:
                raise ValueError(
                    f"enable_int8(min_dim={min_dim}) after "
                    f"enable_int8(min_dim={self._int8_min_dim}): quantized "
                    "weights cannot be re-gated; reload the checkpoint")
            return self.int8_layers
        from ..ops.quant import load_quantized, quantize_unet_params
        sd, scales = quantize_unet_params(self.unet.state_dict(), min_dim)
        self.int8_layers = load_quantized(self.unet, sd, scales)
        self._int8_min_dim = min_dim
        return self.int8_layers

    @torch.no_grad()
    def embed_images(self, images, generator: torch.Generator
                     ) -> torch.Tensor:
        """The repellency bank's embedding: NCHW images in [-1, 1] (numpy
        or tensor) -> VAE latent draws x scaling_factor, in the VAE's
        dtype, the draw's noise from ``generator``."""
        x = torch.as_tensor(images, device=self.device)
        z = self.vae.sample_latent(x, generator)
        return z * self.vae.config.scaling_factor

    # -- text ---------------------------------------------------------------
    @torch.no_grad()
    def _encode(self, texts: Sequence[str], max_length: int) -> torch.Tensor:
        enc = self.tokenizer(list(texts), padding="max_length",
                             max_length=max_length)
        ids = torch.tensor(enc["input_ids"], dtype=torch.long,
                           device=self.device)
        return self.text_encoder(ids)[0]

    def encode_prompt(self, prompt: str, negative_prompt: Optional[str] = None,
                      max_length: Optional[int] = None) -> torch.Tensor:
        """[2, 1, L, D]: the (memoized) unconditional row, then the prompt."""
        max_length = max_length or self.tokenizer.model_max_length
        cond = self._encode([prompt], max_length)
        key = (negative_prompt or "", max_length)
        if self._uncond_memo is None or self._uncond_memo[0] != key:
            self._uncond_memo = (key, self._encode([negative_prompt or ""],
                                                   max_length))
        return torch.stack([self._uncond_memo[1], cond])

    # -- generation ---------------------------------------------------------
    def dispatch_batch(self, prompts: Sequence[str], seeds: Sequence[int],
                       guidance_scales: Sequence[float],
                       num_inference_steps: int = 50,
                       negative_prompt: Optional[str] = None,
                       height: int = 512, width: int = 512,
                       repellency_processor=None,
                       erase_spec: EraseSpec = EraseSpec(),
                       use_beta_gate: bool = True,
                       negative_prompt_space: Optional[Sequence[str]] = None,
                       safree_dict: Optional[dict] = None,
                       safe_config: Optional[dict] = None,
                       freeu=None) -> "PendingGeneration":
        """Enqueue text encoding, the sampling loop and the VAE decode for a
        batch of prompts (CUDA runs them asynchronously); ``fetch()`` on the
        returned handle waits and returns the images. The JAX package's
        keywords are taken: ``negative_prompt_space`` serves SAFREE only;
        ``safree_dict`` asking for SAFREE or latent re-attention, an SLD
        ``safe_config`` and ``freeu`` raise (not ported yet)."""
        sf = safree_dict or {}
        if erase_spec.text_method != "none":
            raise NotImplementedError(
                f"text method {erase_spec.text_method!r} is not ported yet")
        for key, what in (("safree", "SAFREE"), ("svf", "SAFREE's "
                          "self-validation filter"),
                          ("lra", "latent re-attention")):
            if sf.get(key):
                raise NotImplementedError(f"{what} is not ported yet")
        if safe_config is not None:
            raise NotImplementedError("SLD (safe_config) is not ported yet")
        if freeu is not None:
            raise NotImplementedError("FreeU is not ported yet")
        b = len(prompts)
        if len(seeds) != b or len(guidance_scales) != b:
            raise ValueError("one seed and one guidance scale per prompt")
        timer = _StageTimer(self.device)
        with torch.no_grad():
            text = torch.cat([self.encode_prompt(p, negative_prompt)
                              for p in prompts], dim=1)       # [2, B, L, D]
            timer.mark("encode")

            gens = [torch.Generator(device=self.device).manual_seed(int(s))
                    for s in seeds]
            c = self.unet.config.in_channels
            single = (c, height // self.vae_scale_factor,
                      width // self.vae_scale_factor)

            def draw():
                return torch.stack([
                    torch.randn(single, generator=g, device=self.device)
                    for g in gens])

            latents = draw() * self.scheduler.init_noise_sigma
            rep_cfg, refs = None, None
            if repellency_processor is not None and erase_spec.repellency:
                rep_cfg = dataclasses.replace(repellency_processor.config(),
                                              use_beta_gate=use_beta_gate)
                refs = repellency_processor.get_proj_ref().to(self.device)
            gs = torch.tensor(list(guidance_scales), dtype=torch.float32,
                              device=self.device)
            latents, applied = sample_sd(
                self.unet, self.scheduler, text, latents,
                lambda i, salt: draw(), num_inference_steps,
                guidance=GuidanceConfig(), repellency=rep_cfg, refs=refs,
                window=erase_spec.window, guidance_scale=gs)
            timer.mark("loop")
            image = self.vae.decode(latents / self.vae.config.scaling_factor)
            timer.mark("decode")
        return PendingGeneration(self, self.scheduler.timesteps(
            num_inference_steps), latents, image, applied, timer)

    def generate_batch(self, prompts: Sequence[str], seeds: Sequence[int],
                       guidance_scales: Sequence[float], **kwargs):
        """Batched generation; a list of uint8 [H, W, 3] images."""
        return self.dispatch_batch(prompts, seeds, guidance_scales,
                                   **kwargs).fetch()

    def dispatch(self, prompt: str, seed: int = 42,
                 guidance_scale: float = 7.5, **kwargs):
        return self.dispatch_batch([prompt], [seed], [guidance_scale],
                                   **kwargs)

    def __call__(self, prompt: str, **kwargs):
        return self.dispatch(prompt, **kwargs).fetch()


class _StageTimer:
    """CUDA events between the stages of one batch (no synchronization
    until read); on the CPU the host clock after each stage."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list[tuple[str, object]] = [("start", self._now())]

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        import time
        return time.perf_counter()

    def mark(self, name: str) -> None:
        self.marks.append((name, self._now()))

    def ms(self) -> dict[str, float]:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


class PendingGeneration:
    """Handle of an enqueued batch (either pipeline). ``image`` is the
    decoded [B, 3, H, W] device tensor; ``fetch`` waits for the device,
    logs the steps the repellency replaced (by their ``timesteps``), moves
    the images to the host and converts them to uint8."""

    def __init__(self, pipe, timesteps, latents, image, applied, timer):
        self._pipe = pipe
        self._timesteps = timesteps
        self.latents = latents
        self.image = image
        self.applied = applied
        self._timer = timer
        self.stage_ms: dict[str, float] | None = None

    def fetch(self, return_latents: bool = False):
        if self._pipe.device.type == "cuda":
            torch.cuda.synchronize(self._pipe.device)
        self.stage_ms = self._timer.ms()
        applied = self.applied.cpu().numpy()
        logger = self._pipe.logger
        if logger is not None:
            for i in np.nonzero(applied.any(axis=-1))[0]:
                logger.log("-" * 10 + f" Repellency applied at timestep "
                           f"{self._timesteps[i]} " + "-" * 10)
        if return_latents:
            return self.latents
        image = postprocess_image_host(self.image).permute(0, 2, 3, 1)
        return [(img * 255).round().to(torch.uint8).numpy() for img in image]
