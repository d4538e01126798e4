from .clip_text import (CLIP_BIG_G, CLIP_VIT_L_14, CLIPTextConfig,
                        CLIPTextModel)
from .clip_vision import (CLIP_VISION_VIT_B_32, CLIP_VISION_VIT_H_14,
                          CLIP_VISION_VIT_L_14, CLIPVisionConfig,
                          CLIPVisionModel, preprocess_clip)
from .fourier import FreeUConfig
from .mmdit import SD3_MEDIUM, MMDiT, MMDiTConfig
from .t5 import T5_XXL, T5Config, T5Encoder
from .unet import SD14_UNET, UNet2DConditionModel, UNetConfig
from .vae import SD3_VAE, SD14_VAE, AutoencoderKL, VAEConfig

__all__ = ["CLIP_BIG_G", "CLIP_VIT_L_14", "CLIPTextConfig", "CLIPTextModel",
           "CLIP_VISION_VIT_B_32", "CLIP_VISION_VIT_H_14",
           "CLIP_VISION_VIT_L_14", "CLIPVisionConfig", "CLIPVisionModel",
           "preprocess_clip", "FreeUConfig",
           "SD3_MEDIUM", "MMDiT", "MMDiTConfig", "T5_XXL", "T5Config",
           "T5Encoder", "SD14_UNET", "UNet2DConditionModel", "UNetConfig",
           "SD3_VAE", "SD14_VAE", "AutoencoderKL", "VAEConfig"]
