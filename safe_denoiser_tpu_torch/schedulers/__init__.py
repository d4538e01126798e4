from .ddpm import DDPMConfig, DDPMScheduler
from .flow_match import FlowMatchEulerConfig, FlowMatchEulerScheduler

__all__ = ["DDPMScheduler", "DDPMConfig", "FlowMatchEulerConfig",
           "FlowMatchEulerScheduler"]
