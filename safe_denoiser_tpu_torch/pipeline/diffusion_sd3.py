"""SafeDiffusion3Pipeline: the SD3 (MMDiT, flow matching) safe-denoiser
pipeline on one device.

Counterpart of ``safe_denoiser_tpu/pipeline/diffusion_sd3.py``:

  * the triple text encode: CLIP-L and CLIP-bigG penultimate states
    concatenated and zero-padded to the joint width, then concatenated
    along the sequence with the T5-XXL states; pooled = [CLIP-L ; bigG]
    projections (``joint_text_embed``);
  * SAFREE from the T5 first-token states of the leave-one-out masked
    prompts and of the negative space;
  * the 17-phrase nudity negative prompt as the default CFG negative;
  * the flow-match loop with the renoising repellency in the window
    (``sampler.sample_sd3``), then the 16-channel VAE decode;
  * ``enable_int8``: W8A8 int8 on the MMDiT's block linears.

The towers compute as in the JAX package: the CLIP towers in f32, T5, the
MMDiT and the VAE in ``dtype`` (bf16). Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``. Each prompt row draws its initial
latents and its renoise noise from its own ``torch.Generator`` seeded with
the row's seed, before the loop; on ``cuda`` the loop and the decode
replay from CUDA graphs (``graph.py``). ``load_lora`` merges an adapter;
``enable_data_mesh`` and ``enable_bank_sharding`` are the SD-v1
pipeline's (``diffusion.MeshModes``), the MMDiT and the VAE replicated.
What it shares with the FLUX pipeline is ``flow.FlowPipeline``'s.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from ..device import resolve_device
from ..models import (AutoencoderKL, CLIPTextModel, MMDiT, T5Encoder)
from ..schedulers.flow_match import (FlowMatchEulerScheduler,
                                     flow_match_config_from_checkpoint)
from .diffusion import _merge_lora_in_place
from .flow import FlowPipeline, load_component, load_t5_tokenizer
from .safree import (NUDITY_NEGATIVE_PROMPT_SPACE, projection_matrix,
                     safree_projection)
from . import graph
from .sampler import sample_sd3

SD3_NUDITY_NEGATIVE_PROMPT = ", ".join(NUDITY_NEGATIVE_PROMPT_SPACE)


def joint_text_embed(pen_l, proj_l, pen_g, proj_g, t5_states,
                     joint_dim: int):
    """SD3's joint text embedding: [pen_l ; pen_g] zero-padded to
    ``joint_dim`` and concatenated along the sequence with the T5 states
    (cast to the CLIP states' dtype); pooled = [proj_l ; proj_g].
    Returns (embeds [B, L_clip + S_t5, joint_dim], pooled [B, P_l + P_g])."""
    clip = torch.cat([pen_l, pen_g], dim=-1)
    clip = torch.nn.functional.pad(clip, (0, joint_dim - clip.shape[-1]))
    emb = torch.cat([clip, t5_states.to(clip.dtype)], dim=1)
    return emb, torch.cat([proj_l, proj_g], dim=-1)


class SafeDiffusion3Pipeline(FlowPipeline):
    _family = "sd3"
    _sample = staticmethod(sample_sd3)

    def __init__(self, transformer: MMDiT, vae: AutoencoderKL,
                 clip_l: CLIPTextModel, clip_g: CLIPTextModel,
                 t5: T5Encoder, tokenizer, tokenizer_2, tokenizer_3,
                 scheduler: FlowMatchEulerScheduler, device=None,
                 logger=None, max_sequence_length: int = 256):
        self.device = resolve_device(device)
        self.transformer = transformer.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.clip_l = clip_l.to(self.device).eval()
        self.clip_g = clip_g.to(self.device).eval()
        self.t5 = t5.to(self.device).eval()
        self.tokenizer = tokenizer
        self.tokenizer_2 = tokenizer_2
        self.tokenizer_3 = tokenizer_3
        self.scheduler = scheduler
        self.logger = logger
        self.max_sequence_length = max_sequence_length
        self.vae_scale_factor = 2 ** (len(vae.config.block_out_channels) - 1)
        self.joint_dim = transformer.config.joint_attention_dim
        self._graphs = graph.GraphSlot()

    @classmethod
    def from_pretrained(cls, model_dir: str, device=None,
                        dtype: torch.dtype = torch.bfloat16, logger=None):
        """Load an HF-layout SD3 checkpoint dir (transformer/ vae/
        text_encoder/ text_encoder_2/ text_encoder_3/ tokenizer*/
        scheduler/), sharded safetensors included."""
        from ..models.weights import load_component_config, t5_state_dict
        from ..text import CLIPTokenizer

        device = resolve_device(device)

        def sub(name):
            return os.path.join(model_dir, name)

        def load(module, name, fix=None):
            return load_component(module, sub(name), fix)

        tf = load(MMDiT(load_component_config(sub("transformer"), "mmdit")),
                  "transformer")
        vae = load(AutoencoderKL(load_component_config(sub("vae"), "vae")),
                   "vae")
        towers = [load(CLIPTextModel(load_component_config(sub(n),
                                                           "clip_text"),
                                     with_projection=True), n)
                  for n in ("text_encoder", "text_encoder_2")]
        t5 = load(T5Encoder(load_component_config(sub("text_encoder_3"),
                                                  "t5")),
                  "text_encoder_3", t5_state_dict)
        tok = CLIPTokenizer.from_pretrained(sub("tokenizer"))
        tok2 = CLIPTokenizer.from_pretrained(sub("tokenizer_2"))
        tok3 = load_t5_tokenizer(sub("tokenizer_3"))
        sched = FlowMatchEulerScheduler(
            flow_match_config_from_checkpoint(sub("scheduler")))
        return cls(tf.to(dtype), vae.to(dtype), towers[0], towers[1],
                   t5.to(dtype), tok, tok2, tok3, sched, device=device,
                   logger=logger)

    def _latent_channels(self) -> int:
        return self.transformer.config.in_channels

    @property
    def t5_tokenizer(self):
        return self.tokenizer_3

    # -- text ---------------------------------------------------------------
    @torch.no_grad()
    def _encode_one(self, text: str):
        """(embeds [1, L_clip + S_t5, joint], pooled [1, P]) of one text."""
        _, pen_l, _, proj_l = self.clip_l(self._clip_ids(self.tokenizer,
                                                         text))
        _, pen_g, _, proj_g = self.clip_g(self._clip_ids(self.tokenizer_2,
                                                         text))
        t5 = self.t5(self._t5_ids([text]))
        return joint_text_embed(pen_l, proj_l, pen_g, proj_g, t5,
                                self.joint_dim)

    def encode_prompt(self, prompt: str, negative_prompt: str = ""):
        """(embeds [2, 1, L, joint], pooled [2, 1, P]): uncond, then cond."""
        cond, pooled_c = self._encode_one(prompt)
        uncond, pooled_u = self._encode_one(negative_prompt or "")
        return torch.stack([uncond, cond]), torch.stack([pooled_u, pooled_c])

    @torch.no_grad()
    def _masked_encode_prompt_t5(self, prompt: str) -> torch.Tensor:
        """T5 first-token states of the leave-one-out masked prompts."""
        ids = self._t5_ids([prompt], padding="longest")[0]
        n_real = max(len(ids) - 2, 1)
        masked = ids.repeat(n_real, 1)
        idx = torch.arange(n_real, device=ids.device)
        masked[idx, idx + 1] = 0
        return self.t5(masked)[:, 0, :]

    @torch.no_grad()
    def _neg_space_embeds_t5(self, negative_prompt_space: Sequence[str]):
        return self.t5(self._t5_ids(list(negative_prompt_space)))[:, 0, :]

    def _prepare_batch_embeds(self, prompts: Sequence[str],
                              negative_prompt: Optional[str] = None,
                              negative_prompt2: Optional[str] = None,
                              safree: bool = False, sf_alpha: float = 0.01):
        """(embeds [2, B, L, D], pooled [2, B, P]); the uncond row is
        encoded once. With ``safree`` each prompt's pair is projected."""
        if negative_prompt is None:
            negative_prompt = SD3_NUDITY_NEGATIVE_PROMPT
        uncond, pooled_u = self._encode_one(negative_prompt or "")
        per = [self._encode_one(p) for p in prompts]
        cond = torch.cat([e for e, _ in per])                 # [B, L, D]
        pooled_c = torch.cat([p for _, p in per])
        embeds = torch.stack([uncond[0].expand_as(cond), cond])
        pooled = torch.stack([pooled_u[0].expand_as(pooled_c), pooled_c])
        if not safree:
            return embeds, pooled
        neg_space = negative_prompt2 or SD3_NUDITY_NEGATIVE_PROMPT
        neg = self._neg_space_embeds_t5([p.strip()
                                         for p in neg_space.split(",")])
        concept_proj = projection_matrix(neg.float().T)
        rows = []
        for j, p in enumerate(prompts):
            masked = self._masked_encode_prompt_t5(p).float()
            rescaled, n_removed, _ = safree_projection(
                embeds[:, j], masked, projection_matrix(masked.T),
                concept_proj, alpha=sf_alpha, max_length=embeds.shape[2])
            if self.logger is not None:
                self.logger.log(f"Among {masked.shape[0]} tokens, we remove "
                                f"{n_removed}.")
            rows.append(rescaled.to(embeds.dtype))
        return torch.stack(rows, dim=1), pooled

    def enable_int8(self) -> int:
        """W8A8 int8 on the MMDiT's block linears (``ops.quant``): weights
        quantized once here, activations per token at each call.
        Idempotent. Returns the number of quantized linears."""
        if self.int8_layers:
            return self.int8_layers
        from ..ops.quant import load_quantized, quantize_mmdit_params
        sd, scales = quantize_mmdit_params(self.transformer.state_dict())
        self.int8_layers = load_quantized(self.transformer, sd, scales)
        return self.int8_layers

    def load_lora(self, path: str, scale: Optional[float] = None) -> None:
        """Merge a LoRA adapter (``training/lora.py``) into the
        transformer's weights in place: ``SafeDiffusionPipeline.load_lora``'s
        contract (load before ``enable_int8``)."""
        _merge_lora_in_place(self.transformer, path, scale)
