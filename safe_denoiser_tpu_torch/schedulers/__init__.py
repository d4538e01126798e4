from .ddim import DDIMConfig, DDIMScheduler
from .ddpm import DDPMConfig, DDPMScheduler
from .flow_match import (FlowMatchDynamicConfig, FlowMatchEulerConfig,
                         FlowMatchEulerScheduler, flow_match_config)

__all__ = ["DDPMScheduler", "DDPMConfig", "DDIMScheduler", "DDIMConfig",
           "FlowMatchDynamicConfig", "FlowMatchEulerConfig",
           "FlowMatchEulerScheduler", "flow_match_config"]
