"""SafeDiffusionPipeline: tokenizer, CLIP text encoder, UNet, VAE and DDPM
scheduler on one device, with the safe-denoiser repellency hook.

Counterpart of ``safe_denoiser_tpu/pipeline/diffusion.py``: every erase id
of ``ERASE_SPECS`` (plain, ESD, SLD, RECE, SAFREE and their repellency
windows), SAFREE's projection with its fixed or self-validated (``svf``)
window, the SLD safety branch with ``safe_config``, latent re-attention
(``lra``) with FreeU / the SafeGuard filters (``freeu``), the bank's VAE
embedding, the ESD UNet swap, LoRA (``load_lora``), W8A8 int8 on the
UNet's wide transformer blocks (``enable_int8``), and the parallel layer's
two modes (:class:`MeshModes`): a data mesh that splits each batch's rows
over device slots (``enable_data_mesh``) and a bank sharded over them
(``enable_bank_sharding``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise. Each prompt row draws
its initial latents and its per-step noise from its own
``torch.Generator`` seeded with the row's seed, so a row's result does not
depend on the rest of the batch. The noise is drawn before the loop, in
the loop's order; on ``cuda`` the loop and the decode then replay from
CUDA graphs (``graph.py``), on the CPU they run eagerly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models import (AutoencoderKL, CLIPTextModel, FreeUConfig,
                      UNet2DConditionModel)
from ..schedulers import DDPMConfig, DDPMScheduler
from ..utils import profiling
from .safree import (f_beta, projection_and_orthogonal, projection_matrix,
                     safree_projection, svf_beta)
from . import graph
from .sampler import GuidanceConfig, RepellencyWindow, sample_sd

# Safe Latent Diffusion's safety levels (the sld package's SafetyConfig)
SLD_CONFIGS: dict[str, dict] = {
    "WEAK": dict(sld_warmup_steps=15, sld_guidance_scale=200.0,
                 sld_threshold=0.0, sld_momentum_scale=0.0, sld_mom_beta=0.0),
    "MEDIUM": dict(sld_warmup_steps=10, sld_guidance_scale=1000.0,
                   sld_threshold=0.01, sld_momentum_scale=0.3,
                   sld_mom_beta=0.4),
    "STRONG": dict(sld_warmup_steps=7, sld_guidance_scale=2000.0,
                   sld_threshold=0.025, sld_momentum_scale=0.5,
                   sld_mom_beta=0.7),
    "MAX": dict(sld_warmup_steps=0, sld_guidance_scale=5000.0,
                sld_threshold=1.0, sld_momentum_scale=0.5, sld_mom_beta=0.7),
}

# the SLD safety concept (the sld package's SafetyConfig prompt)
SLD_SAFETY_CONCEPT = (
    "an image showing hate, harassment, violence, suffering, humiliation, "
    "harm, suicide, sexual, nudity, bodily fluids, blood, obscene gestures, "
    "illegal activity, drug use, theft, vandalism, weapons, child abuse, "
    "brutality, cruelty")


@dataclasses.dataclass(frozen=True)
class EraseSpec:
    """Text-safety method x repellency gating of one erase id. Only 'sld'
    changes the text path by itself; SAFREE runs where ``safree_dict``
    asks for it, as in the JAX package."""

    text_method: str = "none"         # 'none' | 'safree' | 'sld'
    repellency: bool = False
    window: RepellencyWindow = RepellencyWindow()


_TEXT_METHODS = ("none", "safree", "sld")

# erase id -> spec ('esd' and 'rece' sample as 'std' and 'sld' with a
# fine-tuned UNet swapped in)
ERASE_SPECS: dict[str, EraseSpec] = {
    "std": EraseSpec(),
    "esd": EraseSpec(),
    "std_rep": EraseSpec(repellency=True,
                         window=RepellencyWindow(1000.0, 800.0)),
    "sld": EraseSpec(text_method="sld"),
    "rece": EraseSpec(text_method="sld"),
    "safree": EraseSpec(text_method="safree"),
    "safree_neg_prompt": EraseSpec(text_method="safree"),
    "sld_rep": EraseSpec("sld", True, RepellencyWindow(1000.0, 780.0)),
    "esd_rep": EraseSpec(repellency=True,
                         window=RepellencyWindow(1000.0, 780.0)),
    "rece_rep": EraseSpec("sld", True, RepellencyWindow(1000.0, 780.0)),
    "safree_rep": EraseSpec("safree", True, RepellencyWindow(1000.0, 780.0)),
    "sld_rep_time": EraseSpec("sld", True, RepellencyWindow(1000.0, 780.0)),
    "sld_rep_threshold": EraseSpec(
        "sld", True, RepellencyWindow(step_start=0, step_end=50,
                                      by_timestep=False)),
    "sld_rep_threshold_time": EraseSpec(
        "sld", True, RepellencyWindow(1000.0, 780.0)),
    "safree_neg_prompt_rep": EraseSpec(
        "safree", True, RepellencyWindow(1001.0, -1.0)),
    "safree_neg_prompt_rep_time": EraseSpec(
        "safree", True, RepellencyWindow(1000.0, 800.0)),
    "safree_neg_prompt_rep_threshold": EraseSpec(
        "safree", True, RepellencyWindow(step_start=0, step_end=50,
                                         by_timestep=False)),
    "safree_neg_prompt_rep_threshold_time": EraseSpec(
        "safree", True, RepellencyWindow(1000.0, 780.0)),
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


def _merge_lora_in_place(module: torch.nn.Module, path: str,
                         scale: Optional[float]) -> None:
    """``training.lora.merge_lora_into`` on ``module``'s parameters, the
    merged weights copied into them."""
    from ..training.lora import merge_lora_into
    params = dict(module.named_parameters())
    merged = merge_lora_into(params, path, scale, model_cfg=module.config)
    with torch.no_grad():
        for name, w in merged.items():
            if w is not params[name]:
                params[name].copy_(w)


class MeshModes:
    """The parallel layer's two modes of both pipelines (the JAX
    pipelines' ``enable_data_mesh`` / ``enable_bank_sharding``), which
    refuse each other in either order. A pipeline lists the modules a data
    mesh replicates (``_MESH_MODULES``) and finds a slot's with
    ``_modules_on``."""

    _MESH_MODULES: tuple = ()
    # the JAX pipelines' words, which differ by family
    _DATA_MESH_CONFLICT = (
        "enable_data_mesh with enable_bank_sharding is not supported: the "
        "bank's M axis and the served batch would need a 2-D mesh \u2014 "
        "shard one or the other")
    _data_mesh = None
    _rep_bank = None

    def enable_bank_sharding(self, mesh, axis: str = "data",
                             batch_axis: Optional[str] = None) -> None:
        """Shard the repellency bank's M rows over ``mesh``'s ``axis``:
        each slot scores its shard (B2's raw partials on a GPU), the
        partials are summed across the axis (``parallel/bank.py``). For
        banks too large to replicate (a 10k-row SD3 bank is ~10 GB)."""
        if self._data_mesh is not None:
            raise ValueError(
                "enable_bank_sharding with enable_data_mesh is not "
                "supported: shard the bank's M axis or the served batch, "
                "not both (needs a 2-D mesh)")
        from ..parallel.bank import ShardedBank
        self._rep_bank = ShardedBank(mesh, axis=axis, batch_axis=batch_axis)

    def enable_data_mesh(self, n_devices: Optional[int] = None,
                         mesh=None) -> None:
        """Data-parallel batches: every later ``dispatch_batch`` /
        ``generate_batch`` splits its rows over the slots of ``mesh``
        (default ``parallel.make_mesh(n_devices)``, which needs that many
        GPUs), with the modules replicated once per distinct device (here,
        and again after a change of their weights: ``_modules_on``). Each
        slot captures and replays its own rows' graphs, so a slot's rows
        are those of ``generate_batch`` on that sub-batch."""
        from ..parallel import make_mesh, replicate
        if mesh is None:
            mesh = make_mesh(n_devices)
        if self._rep_bank is not None:
            raise ValueError(self._DATA_MESH_CONFLICT)
        for name in self._MESH_MODULES:
            replicate(getattr(self, name), mesh)
        self._data_mesh = mesh
        self._slot_graphs = [graph.GraphSlot()
                             for _ in range(mesh.devices.size)]

    def _modules_on(self, device) -> tuple:
        """The ``_MESH_MODULES`` on ``device``: the pipeline's own where they
        lie there, else their copies there (``parallel.mesh.module_on``,
        made again once ``load_lora``, ``load_unet_state_dict`` or
        ``enable_int8`` has changed the pipeline's)."""
        from ..parallel.mesh import module_on
        return tuple(module_on(getattr(self, name), device)
                     for name in self._MESH_MODULES)

    def _shard_batch_inputs(self, bufs: dict) -> list:
        """A prepared batch's buffers cut into the data mesh's slots' rows
        (``graph.shard_buffers``)."""
        mesh = self._data_mesh
        n = mesh.devices.size
        b = bufs["latents"].shape[0]
        if b % n != 0:
            raise ValueError(
                f"served batch size {b} must be divisible by the data "
                f"mesh's {n} devices (pick --batch_size a multiple of "
                f"--mesh)")
        return graph.shard_buffers(bufs, list(mesh.devices.flat))

    def _maybe_shard_refs(self, refs):
        """The bank's shards under bank sharding, else ``refs``."""
        if refs is None or self._rep_bank is None:
            return refs
        from ..parallel.bank import shard_bank
        return shard_bank(refs, self._rep_bank.mesh, self._rep_bank.axis)

    def _graphable(self) -> bool:
        return self._rep_bank is None or self._rep_bank.single_device()

    def _launch(self, program, bufs, timer=None) -> "PendingGeneration":
        """Run a prepared batch: through the CUDA graphs on ``cuda``,
        eagerly on the CPU (``graph.GraphSlot.run``); under a data mesh
        each slot its rows (``graph.run_slots``). Without ``timer`` (the
        AOT bundles) the batch gets its own, and with it its
        ``sdt.dispatch`` span where none is open."""
        if timer is None:
            with _StageTimer(self.device) as timer:
                return self._launch(program, bufs, timer)
        if self._data_mesh is None:
            latents, applied, image = self._graphs.run(program, bufs,
                                                       timer.mark)
        else:
            latents, applied, image = graph.run_slots(
                self._slot_graphs, program, self._shard_batch_inputs(bufs),
                self.device, timer.mark)
        return PendingGeneration(self, program.timesteps, latents, image,
                                 applied, timer)


class SafeDiffusionPipeline(MeshModes):
    _MESH_MODULES = ("unet", "vae", "text_encoder")

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
        self._graphs = graph.GraphSlot()

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

    def load_lora(self, path: str, scale: Optional[float] = None) -> None:
        """Merge a LoRA erasure adapter (``training/lora.py``, trained by
        ``runners.train_esd --lora_rank``, or the JAX package's file) into
        the UNet's weights in place. ``scale`` overrides the adapter's
        recorded alpha/rank. Adapters apply to float weights: load before
        ``enable_int8`` (int8 weights raise). The weights' versions move,
        so the next batch re-packs and re-captures its graphs."""
        _merge_lora_in_place(self.unet, path, scale)

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
    def _encode_ids(self, ids) -> tuple:
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return self.text_encoder(ids)

    def _encode(self, texts: Sequence[str], max_length: int) -> torch.Tensor:
        enc = self.tokenizer(list(texts), padding="max_length",
                             max_length=max_length)
        return self._encode_ids(enc["input_ids"])[0]

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

    def _encode_pooled(self, prompts: Sequence[str]) -> torch.Tensor:
        """The EOS-pooled states [N, D] of ``prompts``."""
        enc = self.tokenizer(list(prompts), padding="max_length",
                             max_length=self.tokenizer.model_max_length)
        return self._encode_ids(enc["input_ids"])[2]

    def _masked_encode_prompt(self, prompt: str) -> torch.Tensor:
        """Pooled states [n, D] of the prompt with each of its n real
        tokens replaced by id 0 in turn (SAFREE's leave-one-out)."""
        ids = self.tokenizer([prompt], padding="longest")["input_ids"][0]
        ids = ids[:self.tokenizer.model_max_length]
        n_real = len(ids) - 2
        masked = torch.tensor([ids] * n_real, dtype=torch.long)
        idx = torch.arange(n_real)
        masked[idx, idx + 1] = 0
        return self._encode_ids(masked)[2]

    def _prepare_text(self, prompt: str, negative_prompt: Optional[str],
                      negative_prompt_space: Optional[Sequence[str]],
                      sf: dict, erase_spec: EraseSpec,
                      safe_config: Optional[dict], num_inference_steps: int):
        """One prompt's text: encode, SAFREE's projection and window, the
        branch layout. Returns (text_embeds [branches, 1, L, D], the
        alternative embeddings of the same shape, use_alt [steps] bool, the
        GuidanceConfig)."""
        logger = self.logger
        embeds = self.encode_prompt(prompt, negative_prompt)   # [2,1,L,D]
        steps_idx = torch.arange(num_inference_steps)
        use_alt = torch.zeros(num_inference_steps, dtype=torch.bool)
        embeds_alt = None
        if sf.get("safree"):
            if not negative_prompt_space:
                raise ValueError("SAFREE needs a negative_prompt_space")
            concept_proj = projection_matrix(
                self._encode_pooled(list(negative_prompt_space)).T)
            masked = self._masked_encode_prompt(prompt)
            masked_proj = projection_matrix(masked.T)
            pair = embeds[:, 0]                                 # [2, L, D]
            rescaled, n_removed, _ = safree_projection(
                pair, masked, masked_proj, concept_proj,
                alpha=float(sf.get("alpha", 0.01)), max_length=pair.shape[1])
            if logger is not None:
                logger.log(f"Among {masked.shape[0]} tokens, we remove "
                           f"{int(n_removed)}.")
            embeds_alt = rescaled[:, None]
            if sf.get("svf"):
                proj_ort = projection_and_orthogonal(pair, masked_proj,
                                                     concept_proj)
                mask = self.tokenizer([prompt], padding="max_length",
                                      max_length=pair.shape[1])
                beta = svf_beta(pair[1], proj_ort[1],
                                mask["attention_mask"][0])
                beta_adj = f_beta(beta,
                                  upperbound_timestep=sf.get("up_t", 10),
                                  concept_type=sf.get("category", "nudity"))
                if logger is not None:
                    logger.log(f"beta : {beta}, adjusted_beta: {beta_adj}")
                use_alt = steps_idx <= beta_adj
            else:
                lo, hi = sf.get("re_attn_t", [-1, 1001])
                use_alt = (steps_idx >= lo) & (steps_idx <= hi)

        if erase_spec.text_method == "sld":
            extra = self._encode([SLD_SAFETY_CONCEPT],
                                 embeds.shape[2])[None]         # [1,1,L,D]
            guidance = GuidanceConfig(
                mode="sld", **(safe_config or SLD_CONFIGS["STRONG"]))
        elif sf.get("lra"):
            extra = embeds[1:2]
            guidance = GuidanceConfig(mode="lra")
        else:
            extra = None
            guidance = GuidanceConfig()
        if extra is not None:
            embeds = torch.cat([embeds, extra])
            if embeds_alt is not None:
                embeds_alt = torch.cat([embeds_alt, extra])
        return (embeds, embeds if embeds_alt is None else embeds_alt,
                use_alt, guidance)

    # -- generation ---------------------------------------------------------
    def _prepare_batch(self, prompts: Sequence[str], seeds: Sequence[int],
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
                       freeu: Optional[FreeUConfig] = None,
                       mark=lambda name: None):
        """Text preparation (then ``mark("encode")``) and the batch's
        inputs: ``(graph.Program, buffers)`` (``_batch_inputs``).
        ``safree_dict``: ``safree`` (the projection; its window from
        ``re_attn_t`` or, with ``svf``, from beta with ``up_t`` and
        ``category``), ``alpha``, ``lra`` (the 3-way re-attention batch).
        ``safe_config``: SLD's hyperparameters (default STRONG) for an
        'sld' erase spec. ``freeu``: a FreeUConfig; its SafeGuard modes need
        ``lra``. The batch's branches fold into one UNet batch."""
        sf = safree_dict or {}
        if erase_spec.text_method not in _TEXT_METHODS:
            raise ValueError(f"text method {erase_spec.text_method!r}: one "
                             f"of {_TEXT_METHODS}")
        if freeu is not None and freeu.mode != "freeu" and not sf.get("lra"):
            raise ValueError(
                "SafeGuard Fourier modes ('high'/'low'/'all') require the "
                "3-way latent re-attention batch (safree_dict['lra']=True); "
                "use mode='freeu' for plain FreeU scaling")
        b = len(prompts)
        if len(seeds) != b or len(guidance_scales) != b:
            raise ValueError("one seed and one guidance scale per prompt")
        with torch.no_grad():
            with profiling.span("sdt.dispatch.text"):
                per = [self._prepare_text(p, negative_prompt,
                                          negative_prompt_space, sf,
                                          erase_spec, safe_config,
                                          num_inference_steps)
                       for p in prompts]
                # [branches, B, L, D]
                text = torch.cat([t for t, _, _, _ in per], dim=1)
                alt = use_alt = None
                if sf.get("safree"):
                    alt = torch.cat([a for _, a, _, _ in per], dim=1)
                    use_alt = torch.stack([u for _, _, u, _ in per], dim=1)
                mark("encode")
            with profiling.span("sdt.dispatch.inputs"):
                rep_cfg, refs = None, None
                if repellency_processor is not None and \
                        erase_spec.repellency:
                    rep_cfg = dataclasses.replace(
                        repellency_processor.config(),
                        use_beta_gate=use_beta_gate)
                    refs = repellency_processor.get_proj_ref()
                return self._batch_inputs(
                    text, alt, use_alt, seeds, guidance_scales,
                    num_inference_steps, height, width, per[0][3], rep_cfg,
                    refs, erase_spec.window, freeu)

    def _batch_inputs(self, text, alt, use_alt, seeds, guidance_scales,
                      num_inference_steps: int, height: int, width: int,
                      guidance: GuidanceConfig, rep_cfg, refs,
                      window: RepellencyWindow, freeu):
        """The sampling program of these statics and the batch's buffers:
        initial latents and every noise draw of the loop (``graph.
        noise_slots``) from per-row generators seeded with ``seeds``, the
        text (``alt``/``use_alt``: SAFREE's, or None), guidance scales,
        the bank, the timestep table."""
        dev = self.device
        b = len(seeds)
        gens = [torch.Generator(device=dev).manual_seed(int(s))
                for s in seeds]
        single = (self.unet.config.in_channels,
                  height // self.vae_scale_factor,
                  width // self.vae_scale_factor)

        def draw():
            return torch.stack([torch.randn(single, generator=g, device=dev)
                                for g in gens])

        timesteps = self.scheduler.timesteps(num_inference_steps)
        in_window = [rep_cfg is not None and window.mask(i, int(t))
                     for i, t in enumerate(timesteps)]
        slots = graph.noise_slots(in_window, step_noise=True)
        latents = draw() * self.scheduler.init_noise_sigma
        bufs = {"latents": latents,
                "noise": graph.draw_noise(draw, len(slots), latents),
                "text": text.to(dev),
                "gs": torch.tensor(list(guidance_scales), dtype=torch.float32,
                                   device=dev),
                "timesteps": torch.as_tensor(timesteps, device=dev)}
        if alt is not None:
            bufs["alt"] = alt.to(dev)
            bufs["use_alt"] = torch.as_tensor(use_alt, dtype=torch.bool,
                                              device=dev)
        if rep_cfg is not None:
            bufs.update(graph.bank_buffers(self._maybe_shard_refs(
                refs.to(device=dev, dtype=torch.float32))))
        unet, vae, sch = self.unet, self.vae, self.scheduler
        rep_bank = self._rep_bank

        def loop(bufs, steps=None):
            noise = bufs["noise"]
            return sample_sd(
                self._modules_on(bufs["latents"].device)[0], sch,
                bufs["text"], bufs["latents"],
                lambda i, salt: noise[slots[i, salt]], num_inference_steps,
                guidance=guidance, repellency=rep_cfg,
                refs=graph.bank_from(bufs), window=window,
                guidance_scale=bufs["gs"], text_embeds_alt=bufs.get("alt"),
                use_alt_per_step=bufs.get("use_alt"), freeu=freeu,
                t_table=bufs["timesteps"], steps=steps, rep_bank=rep_bank)

        def decode(latents):
            vae = self._modules_on(latents.device)[1]
            return vae.decode(latents / vae.config.scaling_factor)

        key = ("sd", id(unet), id(vae), unet.conv_in.weight.dtype,
               self._int8_min_dim, type(sch).__name__, sch.config,
               num_inference_steps, guidance, rep_cfg, window, freeu,
               rep_bank, graph.weights_version(unet, vae))
        return (graph.Program(key, loop, decode, graph.warm_step(in_window),
                              timesteps, self._graphable()), bufs)

    def dispatch_batch(self, prompts: Sequence[str], seeds: Sequence[int],
                       guidance_scales: Sequence[float], **kwargs
                       ) -> "PendingGeneration":
        """Enqueue text preparation, the sampling loop and the VAE decode
        for a batch of prompts (CUDA runs them asynchronously; the loop and
        the decode from CUDA graphs, ``graph.py``); ``fetch()`` on the
        returned handle waits and returns the images. Keywords: those of
        ``_prepare_batch`` (steps, size, repellency, erase spec, SAFREE,
        SLD, FreeU)."""
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
                 guidance_scale: float = 7.5, **kwargs):
        return self.dispatch_batch([prompt], [seed], [guidance_scale],
                                   **kwargs)

    def __call__(self, prompt: str, **kwargs):
        return self.dispatch(prompt, **kwargs).fetch()


class _StageTimer:
    """The stages of one batch, on both clocks. Device: CUDA events between
    the stages (no synchronization until read), all on the stream that was
    current when the batch began (a data mesh's slots on other GPUs run on
    their own streams, which these marks do not time); on the CPU the host
    clock after each stage. Host: inside ``with``, the batch's
    ``sdt.dispatch`` span, opened here unless the caller (the batcher)
    holds one open on this thread; ``root`` is its id, the parent of the
    batch's ``sdt.fetch``. The stages' host spans close where the marks
    are made."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.current_stream() if self.cuda else None
        self.marks: list[tuple[str, object]] = [("start", self._now())]
        self.root: Optional[int] = None
        self._own: Optional[profiling.span] = None

    def __enter__(self) -> "_StageTimer":
        root = profiling.enclosing("sdt.dispatch")
        if root is None:
            root = self._own = profiling.span("sdt.dispatch").__enter__()
        self.root = root.id
        return self

    def __exit__(self, *exc) -> bool:
        if self._own is not None:
            self._own.__exit__(*exc)
        return False

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
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
        with profiling.span("sdt.fetch", parent=self._timer.root):
            with profiling.span("sdt.fetch.wait"):
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
            with profiling.span("sdt.fetch.host"):
                image = postprocess_image_host(self.image)
                return [(img * 255).round().to(torch.uint8).numpy()
                        for img in image.permute(0, 2, 3, 1)]
