from .clip_text import CLIP_VIT_L_14, CLIPTextConfig, CLIPTextModel
from .unet import SD14_UNET, UNet2DConditionModel, UNetConfig
from .vae import SD14_VAE, AutoencoderKL, VAEConfig

__all__ = ["CLIP_VIT_L_14", "CLIPTextConfig", "CLIPTextModel", "SD14_UNET",
           "UNet2DConditionModel", "UNetConfig", "SD14_VAE", "AutoencoderKL",
           "VAEConfig"]
