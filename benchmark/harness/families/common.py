"""What the families share: the tokenizer the benchmark serves, the
negative bank, the VAE's decoder conv table, the FLOP count and the
reference's outputs for the check."""

from __future__ import annotations

import gc

import torch

from ...reference.sample import check_recipe, latent_shape
from ..check import reference_outputs
from ..flops import flops_per_image
from ..weights import stream_seed, draw_checkpoint


def draw_bank(cfg: dict, recipe: dict, seed: int, device) -> torch.Tensor:
    """The raw negative bank [M, C, h, w] (f32, N(0, 1)) of the run's seed;
    the repellency normalizes it over channels."""
    shape = latent_shape(cfg["components"]["vae"], recipe)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, 1000))
    return torch.randn((recipe["repellency"]["bank_rows"], *shape),
                       generator=gen, device=device)


class FamilyBase:
    family = ""

    def __init__(self, cfg: dict, recipe: dict, seed: int, device):
        check_recipe(recipe)
        self.cfg, self.recipe, self.seed = cfg, recipe, seed
        self.device = torch.device(device)
        self._flops = None

    @staticmethod
    def tokenizer():
        """CLIP's byte-level BPE without merges (the published vocabularies
        are not in the repository)."""
        from safe_denoiser_tpu_torch.text import CLIPTokenizer
        return CLIPTokenizer([], None)

    @staticmethod
    def vae_config(vae_config_cls, v: dict):
        return vae_config_cls(
            in_channels=v["in_channels"], out_channels=v["out_channels"],
            latent_channels=v["latent_channels"],
            block_out_channels=tuple(v["block_out_channels"]),
            layers_per_block=v["layers_per_block"],
            norm_num_groups=v["norm_num_groups"],
            scaling_factor=v["scaling_factor"],
            shift_factor=v.get("shift_factor", 0.0),
            sample_size=v["sample_size"],
            use_quant_conv=v.get("use_quant_conv", True),
            use_post_quant_conv=v.get("use_post_quant_conv", True))

    def latent_shape(self) -> tuple:
        return latent_shape(self.cfg["components"]["vae"], self.recipe)

    def in_window_steps(self) -> int:
        hi, lo = self.recipe["repellency"]["window"]
        return sum(lo <= t <= hi for t in self.timesteps())

    def expected_launches(self) -> dict:
        """A batch's launches of the kernels whose counts the port's
        records keep: the fused attention and the repellency score."""
        return {"attention": sum(c[-1] for c in self.attention_calls()),
                "rbf": self.in_window_steps()}

    def conv3x3_calls(self) -> list:
        """(B, H, W, Ci, Co, residual, calls a batch) of the VAE decoder's
        resnet convs that the fused 3x3 conv serves (Ci and Co multiples
        of 128, W a multiple of 16): conv1 without, conv2 with the
        residual."""
        v = self.cfg["components"]["vae"]
        rev = v["block_out_channels"][::-1]
        _, h, w = self.latent_shape()
        b = self.recipe["batch"]
        rows: dict = {}

        def resnet(ci, co, hh, ww):
            for shape in ((b, hh, ww, ci, co, False),
                          (b, hh, ww, co, co, True)):
                if shape[3] % 128 == 0 and shape[4] % 128 == 0 \
                        and ww % 16 == 0:
                    rows[shape] = rows.get(shape, 0) + 1

        resnet(rev[0], rev[0], h, w)
        resnet(rev[0], rev[0], h, w)
        cin = rev[0]
        for i, ch in enumerate(rev):
            for j in range(v["layers_per_block"] + 1):
                resnet(cin if j == 0 else ch, ch, h << i, w << i)
            cin = ch
        return [(*shape, n) for shape, n in rows.items()]

    def flops_per_image(self) -> dict:
        if self._flops is None:
            self._flops = flops_per_image(self.family, self.cfg, self.recipe)
        return self._flops

    def release(self) -> None:
        """Free the program's state: pipeline, graphs, weights."""
        self.__dict__.pop("pipe", None)
        self.__dict__.pop("processor", None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_text(self, request) -> dict:
        """The program's text states of [the recipe's negative prompt, the
        request's prompt], as the family's reference ``text`` names them
        (float32, on the host)."""
        raise NotImplementedError(f"{self.family}: no program_text")

    def reference(self, sample: list, needs: set) -> list:
        """``check.reference_outputs`` of each served entry of ``sample``,
        from a checkpoint and a bank drawn again from the run's seed."""
        tensors = draw_checkpoint(self.cfg, self.seed, self.device)
        bank = draw_bank(self.cfg, self.recipe, self.seed, self.device)
        return [reference_outputs(self.family, tensors, self.cfg,
                                  self.recipe, bank, s.request, s.latents,
                                  needs, self.device)
                for s in sample]
