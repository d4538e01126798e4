from .ddim import DDIMConfig, DDIMScheduler
from .ddpm import DDPMConfig, DDPMScheduler
from .flow_match import FlowMatchEulerConfig, FlowMatchEulerScheduler

__all__ = ["DDPMScheduler", "DDPMConfig", "DDIMScheduler", "DDIMConfig",
           "FlowMatchEulerConfig", "FlowMatchEulerScheduler"]
