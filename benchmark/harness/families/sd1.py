"""The SD-v1 family: the port's ``SafeDiffusionPipeline`` built at a
configuration's widths from the run's seed, the keywords a traffic mix's
recipe gives its ``dispatch_batch``, and the shape tables the kernel
rooflines read (from the configuration alone)."""

from __future__ import annotations

import torch

from ..weights import draw_checkpoint
from .common import FamilyBase, draw_bank


class System(FamilyBase):
    family = "sd1"

    def __init__(self, cfg: dict, recipe: dict, seed: int, device):
        super().__init__(cfg, recipe, seed, device)
        if recipe["sampler"] not in ("ddpm", "ddim"):
            raise ValueError(f"no SD-v1 sampler {recipe['sampler']!r}")
        from safe_denoiser_tpu_torch.models import (
            AutoencoderKL, CLIPTextConfig, CLIPTextModel,
            UNet2DConditionModel, UNetConfig, VAEConfig)
        from safe_denoiser_tpu_torch.pipeline import (
            EraseSpec, RepellencyWindow, SafeDiffusionPipeline)
        from safe_denoiser_tpu_torch.repellency import KernelFastRepellency
        from safe_denoiser_tpu_torch.schedulers import (
            DDIMConfig, DDIMScheduler, DDPMConfig, DDPMScheduler)

        comps = cfg["components"]
        u, v, t = comps["unet"], comps["vae"], comps["text_encoder"]
        tok = self.tokenizer()
        with torch.device("meta"):
            unet = UNet2DConditionModel(UNetConfig(
                sample_size=u["sample_size"], in_channels=u["in_channels"],
                out_channels=u["out_channels"],
                block_out_channels=tuple(u["block_out_channels"]),
                layers_per_block=u["layers_per_block"],
                cross_attention_dim=u["cross_attention_dim"],
                num_attention_heads=u["attention_head_dim"],
                norm_num_groups=u["norm_num_groups"], norm_eps=u["norm_eps"],
                freq_shift=u["freq_shift"],
                flip_sin_to_cos=u["flip_sin_to_cos"]))
            vae = AutoencoderKL(self.vae_config(VAEConfig, v))
            text = CLIPTextModel(CLIPTextConfig(
                vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                num_layers=t["num_hidden_layers"],
                num_heads=t["num_attention_heads"],
                max_position_embeddings=t["max_position_embeddings"],
                intermediate_size=t["intermediate_size"],
                hidden_act=t["hidden_act"],
                projection_dim=t["projection_dim"],
                eos_token_id=tok.eos_token_id,
                layer_norm_eps=t["layer_norm_eps"]))
        tensors = draw_checkpoint(cfg, seed, device)
        for module, name in ((unet, "unet"), (vae, "vae"),
                             (text, "text_encoder")):
            module.load_state_dict(tensors[name], strict=True, assign=True)
        s = cfg["scheduler"]
        common = dict(num_train_timesteps=s["num_train_timesteps"],
                      beta_start=s["beta_start"], beta_end=s["beta_end"],
                      beta_schedule=s["beta_schedule"],
                      steps_offset=s["steps_offset"],
                      clip_sample=s["clip_sample"])
        if recipe["sampler"] == "ddim":
            scheduler = DDIMScheduler(DDIMConfig(
                set_alpha_to_one=s["set_alpha_to_one"], eta=0.0, **common))
        else:
            scheduler = DDPMScheduler(DDPMConfig(**common))
        self.pipe = SafeDiffusionPipeline(unet, vae, text, tok, scheduler,
                                          device=device)
        rep = recipe["repellency"]
        # the gate is off (FamilyBase refuses it on); a non-positive
        # threshold without a noisy bank keeps KernelFastRepellency's own
        # gate open for every sample
        self.processor = KernelFastRepellency(
            ref_data=draw_bank(cfg, recipe, seed, device),
            embed_fn=lambda x: x, sigma=rep["sigma"], scale=rep["scale"],
            beta_threshold=-1.0, device=device)
        self.erase_spec = EraseSpec(repellency=True,
                                    window=RepellencyWindow(*rep["window"]))

    def dispatch_kwargs(self) -> dict:
        r = self.recipe
        return dict(num_inference_steps=r["steps"],
                    negative_prompt=r["negative_prompt"],
                    height=r["height"], width=r["width"],
                    repellency_processor=self.processor,
                    erase_spec=self.erase_spec,
                    use_beta_gate=False)

    def program_text(self, request) -> dict:
        embeds = self.pipe.encode_prompt(request.prompt,
                                         self.recipe["negative_prompt"])
        return {"context": embeds[:, 0].float().cpu()}

    def serve_fn(self, batch: int):
        """``runners.serve.build_generate_fn`` over this pipeline, with the
        serve runner's flags for the recipe."""
        from safe_denoiser_tpu_torch.runners.serve import (build_generate_fn,
                                                          parse_args)
        r = self.recipe
        argv = ["--batch_size", str(batch),
                "--num_inference_steps", str(r["steps"]),
                "--image_length", str(r["height"]),
                "--device", str(self.device)]
        if r["negative_prompt"]:
            argv += ["--negative_prompt", r["negative_prompt"]]
        return build_generate_fn(parse_args(argv), self.pipe,
                                 self.processor, self.erase_spec, None)

    def timesteps(self) -> list:
        return [float(t) for t in self.pipe.scheduler.timesteps(
            self.recipe["steps"])]

    def attention_calls(self) -> list:
        """(B, S, H, D, calls a batch) of the UNet's self-attention that
        the fused kernel serves: levels with cross-attention blocks whose
        S >= 512 and D <= 256."""
        u = self.cfg["components"]["unet"]
        chans, per = u["block_out_channels"], u["layers_per_block"]
        heads = u["attention_head_dim"]
        _, h, w = self.latent_shape()
        b, steps = 2 * self.recipe["batch"], self.recipe["steps"]
        out = []
        for level, ch in enumerate(chans[:-1]):
            s = (h >> level) * (w >> level)
            if s >= 512 and ch // heads <= 256:
                out.append((b, s, heads, ch // heads,
                            (2 * per + 1) * steps))
        return out
