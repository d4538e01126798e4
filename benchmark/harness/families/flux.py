"""The FLUX family: the port's ``SafeFluxPipeline`` built at a
configuration's widths from the run's seed (CLIP-L, T5, the FLUX
transformer and the 16-channel VAE), the keywords a traffic mix's recipe
gives its ``dispatch_batch``, the shape tables the attention and qk_rope
rooflines read, and a reference check that holds one component of the
checkpoint on the card at a time."""

from __future__ import annotations

import gc

import torch

from ...reference import sample as ref
from ..weights import draw_checkpoint
from .common import FamilyBase, draw_bank


class System(FamilyBase):
    family = "flux"

    def __init__(self, cfg: dict, recipe: dict, seed: int, device):
        super().__init__(cfg, recipe, seed, device)
        if recipe["sampler"] != "flow_match":
            raise ValueError(f"no FLUX sampler {recipe['sampler']!r}")
        if recipe["repellency"]["sigma"] != 1.0:
            # the pipeline runs the reference's fast SD3 module at sigma 1
            raise ValueError("FLUX's repellency runs at sigma 1.0 only")
        from safe_denoiser_tpu_torch.models import (
            AutoencoderKL, CLIPTextConfig, CLIPTextModel, FluxConfig,
            FluxTransformer, T5Config, T5Encoder, VAEConfig)
        from safe_denoiser_tpu_torch.pipeline import RepellencyWindow
        from safe_denoiser_tpu_torch.pipeline.diffusion_flux import \
            SafeFluxPipeline
        from safe_denoiser_tpu_torch.repellency import KernelFastRepellency
        from safe_denoiser_tpu_torch.schedulers import (
            FlowMatchEulerScheduler, flow_match_config)

        comps = cfg["components"]
        m, c, t5c = (comps["transformer"], comps["text_encoder"],
                     comps["text_encoder_2"])
        tok = self.tokenizer()
        with torch.device("meta"):
            modules = {
                "transformer": FluxTransformer(FluxConfig(
                    in_channels=m["in_channels"], num_layers=m["num_layers"],
                    num_single_layers=m["num_single_layers"],
                    num_heads=m["num_attention_heads"],
                    head_dim=m["attention_head_dim"],
                    joint_attention_dim=m["joint_attention_dim"],
                    pooled_projection_dim=m["pooled_projection_dim"],
                    guidance_embeds=m["guidance_embeds"],
                    axes_dims_rope=tuple(m["axes_dims_rope"]))),
                "text_encoder": CLIPTextModel(CLIPTextConfig(
                    vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                    num_layers=c["num_hidden_layers"],
                    num_heads=c["num_attention_heads"],
                    max_position_embeddings=c["max_position_embeddings"],
                    intermediate_size=c["intermediate_size"],
                    hidden_act=c["hidden_act"],
                    projection_dim=c["projection_dim"],
                    eos_token_id=tok.eos_token_id,
                    layer_norm_eps=c["layer_norm_eps"]),
                    with_projection=False),
                "text_encoder_2": T5Encoder(T5Config(
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
        self.pipe = SafeFluxPipeline(
            modules["transformer"], modules["vae"], modules["text_encoder"],
            modules["text_encoder_2"], tok, tok,
            FlowMatchEulerScheduler(flow_match_config(cfg["scheduler"])),
            device=device, max_sequence_length=cfg["max_sequence_length"])
        rep = recipe["repellency"]
        self.processor = KernelFastRepellency(
            ref_data=draw_bank(cfg, recipe, seed, device),
            embed_fn=lambda x: x, sigma=rep["sigma"], scale=rep["scale"],
            normalize_x=True, device=device)
        self.window = RepellencyWindow(*rep["window"])

    def dispatch_kwargs(self) -> dict:
        r = self.recipe
        return dict(num_inference_steps=r["steps"], height=r["height"],
                    width=r["width"], repellency_processor=self.processor,
                    window=self.window)

    def program_text(self, request) -> dict:
        """The program's T5 states and CLIP-L pooled output of the
        request's prompt (FLUX takes no negative prompt)."""
        t5, pooled = self.pipe.encode_prompt(request.prompt)
        return {"t5": t5.float().cpu(), "pooled": pooled.float().cpu()}

    def _tokens(self) -> tuple:
        """(text tokens, image tokens) of the joint sequence."""
        _, h, w = self.latent_shape()
        return self.cfg["max_sequence_length"], (h // 2) * (w // 2)

    def timesteps(self) -> list:
        ts, _ = self.pipe.scheduler.timesteps_and_sigmas(
            self.recipe["steps"], image_seq_len=self._tokens()[1])
        return [float(t) for t in ts]

    def attention_calls(self) -> list:
        """(B, S, H, D, calls a batch) of the attention: every double and
        single block at every step over [text ; image] tokens."""
        m = self.cfg["components"]["transformer"]
        blocks = m["num_layers"] + m["num_single_layers"]
        return [(self.recipe["batch"], sum(self._tokens()),
                 m["num_attention_heads"], m["attention_head_dim"],
                 blocks * self.recipe["steps"])]

    def qk_rope_calls(self) -> list:
        """(B, segment lengths, H, D, calls a batch) of ``ops.qk_rope``:
        the double blocks' two segments [text ; image] (v joined too), the
        single blocks' one."""
        m = self.cfg["components"]["transformer"]
        b, steps = self.recipe["batch"], self.recipe["steps"]
        h, d = m["num_attention_heads"], m["attention_head_dim"]
        txt, img = self._tokens()
        return [(b, (txt, img), h, d, m["num_layers"] * steps),
                (b, (txt + img,), h, d, m["num_single_layers"] * steps)]

    def expected_launches(self) -> dict:
        """The fused attention and the repellency score, one qk_rope a
        block, and ``adaln``: six a double block, two a single block and
        the head's one, a transformer call."""
        m = self.cfg["components"]["transformer"]
        steps = self.recipe["steps"]
        return {**super().expected_launches(),
                "qk_rope": sum(c[-1] for c in self.qk_rope_calls()),
                "adaln": (6 * m["num_layers"] + 2 * m["num_single_layers"]
                          + 1) * steps}

    def reference(self, sample: list, needs: set) -> list:
        """``check.reference_outputs`` of each served entry of ``sample``,
        the checkpoint drawn again from the run's seed one stage's
        components at a time (the towers, the transformer, the VAE), each
        freed before the next is drawn."""
        cfg, recipe, dev = self.cfg, self.recipe, self.device
        outs: list = [{} for _ in sample]

        def stage(*names):
            return draw_checkpoint(cfg, self.seed, dev, only=names)

        def free():
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        if needs & {"text", "sample"}:
            tensors = stage("text_encoder", "text_encoder_2")
            for out, s in zip(outs, sample):
                out["text"] = ref.text(self.family, tensors, cfg, recipe,
                                       s.request.prompt, None, dev)
            del tensors
            free()
        if "sample" in needs:
            tensors = stage("transformer")
            bank = draw_bank(cfg, recipe, self.seed, dev)
            for out, s in zip(outs, sample):
                out["latents"] = ref.loop(
                    self.family, tensors, cfg, recipe, out["text"],
                    s.request.seed, s.request.guidance, bank, None, dev)
            del tensors, bank
            free()
        if needs & {"sample", "decode"}:
            tensors = stage("vae")
            for out, s in zip(outs, sample):
                if "sample" in needs:
                    out["image"] = ref.decode(tensors, cfg, out["latents"])
                if "decode" in needs and s.latents is not None:
                    out["decoded"] = ref.decode(
                        tensors, cfg, torch.as_tensor(s.latents)[None].to(
                            device=dev, dtype=torch.float32))
        return outs
