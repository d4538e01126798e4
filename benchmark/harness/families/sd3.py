"""The SD3 family: the port's ``SafeDiffusion3Pipeline`` built at a
configuration's widths from the run's seed (CLIP-L, CLIP-bigG, T5, the
MMDiT and the 16-channel VAE), the keywords a traffic mix's recipe gives
its ``dispatch_batch``, and the shape table the attention roofline
reads."""

from __future__ import annotations

import torch

from ..weights import draw_checkpoint
from .common import FamilyBase, draw_bank


class System(FamilyBase):
    family = "sd3"

    def __init__(self, cfg: dict, recipe: dict, seed: int, device):
        super().__init__(cfg, recipe, seed, device)
        if recipe["sampler"] != "flow_match":
            raise ValueError(f"no SD3 sampler {recipe['sampler']!r}")
        if recipe["repellency"]["sigma"] != 1.0:
            # the pipeline runs the reference's fast SD3 module at sigma 1
            raise ValueError("SD3's repellency runs at sigma 1.0 only")
        from safe_denoiser_tpu_torch.models import (
            AutoencoderKL, CLIPTextConfig, CLIPTextModel, MMDiT,
            MMDiTConfig, T5Config, T5Encoder, VAEConfig)
        from safe_denoiser_tpu_torch.pipeline import RepellencyWindow
        from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
            SafeDiffusion3Pipeline
        from safe_denoiser_tpu_torch.repellency import KernelFastRepellency
        from safe_denoiser_tpu_torch.schedulers import (
            FlowMatchEulerConfig, FlowMatchEulerScheduler)

        comps = cfg["components"]
        m, t5c = comps["transformer"], comps["text_encoder_3"]
        tok = self.tokenizer()

        def clip(c):
            return CLIPTextModel(CLIPTextConfig(
                vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                num_layers=c["num_hidden_layers"],
                num_heads=c["num_attention_heads"],
                max_position_embeddings=c["max_position_embeddings"],
                intermediate_size=c["intermediate_size"],
                hidden_act=c["hidden_act"],
                projection_dim=c["projection_dim"],
                eos_token_id=tok.eos_token_id,
                layer_norm_eps=c["layer_norm_eps"]), with_projection=True)

        with torch.device("meta"):
            modules = {
                "transformer": MMDiT(MMDiTConfig(
                    sample_size=m["sample_size"], patch_size=m["patch_size"],
                    in_channels=m["in_channels"],
                    out_channels=m["out_channels"],
                    num_layers=m["num_layers"],
                    num_heads=m["num_attention_heads"],
                    head_dim=m["attention_head_dim"],
                    joint_attention_dim=m["joint_attention_dim"],
                    caption_projection_dim=m["caption_projection_dim"],
                    pooled_projection_dim=m["pooled_projection_dim"],
                    pos_embed_max_size=m["pos_embed_max_size"])),
                "text_encoder": clip(comps["text_encoder"]),
                "text_encoder_2": clip(comps["text_encoder_2"]),
                "text_encoder_3": T5Encoder(T5Config(
                    vocab_size=t5c["vocab_size"], d_model=t5c["d_model"],
                    d_kv=t5c["d_kv"], d_ff=t5c["d_ff"],
                    num_layers=t5c["num_layers"],
                    num_heads=t5c["num_heads"],
                    relative_attention_num_buckets=t5c[
                        "relative_attention_num_buckets"],
                    relative_attention_max_distance=t5c[
                        "relative_attention_max_distance"],
                    layer_norm_epsilon=t5c["layer_norm_epsilon"])),
                "vae": AutoencoderKL(self.vae_config(VAEConfig,
                                                     comps["vae"]))}
        tensors = draw_checkpoint(cfg, seed, device)
        for name, module in modules.items():
            module.load_state_dict(tensors.pop(name), strict=True,
                                   assign=True)
        s = cfg["scheduler"]
        self.pipe = SafeDiffusion3Pipeline(
            modules["transformer"], modules["vae"], modules["text_encoder"],
            modules["text_encoder_2"], modules["text_encoder_3"], tok, tok,
            tok, FlowMatchEulerScheduler(FlowMatchEulerConfig(
                num_train_timesteps=s["num_train_timesteps"],
                shift=s["shift"])),
            device=device, max_sequence_length=cfg["max_sequence_length"])
        rep = recipe["repellency"]
        self.processor = KernelFastRepellency(
            ref_data=draw_bank(cfg, recipe, seed, device),
            embed_fn=lambda x: x, sigma=rep["sigma"], scale=rep["scale"],
            normalize_x=True, device=device)
        self.window = RepellencyWindow(*rep["window"])

    def dispatch_kwargs(self) -> dict:
        r = self.recipe
        return dict(num_inference_steps=r["steps"],
                    negative_prompt=r["negative_prompt"],
                    height=r["height"], width=r["width"],
                    repellency_processor=self.processor, window=self.window)

    def program_text(self, request) -> dict:
        embeds, pooled = self.pipe.encode_prompt(
            request.prompt, self.recipe["negative_prompt"])
        embeds = embeds[:, 0].float().cpu()
        n = self.cfg["components"]["text_encoder"]["max_position_embeddings"]
        return {"clip": embeds[:, :n], "t5": embeds[:, n:],
                "pooled": pooled[:, 0].float().cpu()}

    def timesteps(self) -> list:
        ts, _ = self.pipe.scheduler.timesteps_and_sigmas(self.recipe["steps"])
        return [float(t) for t in ts]

    def attention_calls(self) -> list:
        """(B, S, H, D, calls a batch) of the joint attention: every block
        at every step over [image ; context] tokens."""
        m = self.cfg["components"]["transformer"]
        _, h, w = self.latent_shape()
        p = m["patch_size"]
        s = (h // p) * (w // p) + 77 + self.cfg["max_sequence_length"]
        return [(2 * self.recipe["batch"], s, m["num_attention_heads"],
                 m["attention_head_dim"],
                 m["num_layers"] * self.recipe["steps"])]
