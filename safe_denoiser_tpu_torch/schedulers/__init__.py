from .ddpm import DDPMConfig, DDPMScheduler

__all__ = ["DDPMScheduler", "DDPMConfig"]
