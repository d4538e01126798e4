from .diffusion import (
    ERASE_SPECS,
    SLD_CONFIGS,
    SLD_SAFETY_CONCEPT,
    EraseSpec,
    PendingGeneration,
    SafeDiffusionPipeline,
    postprocess_image_host,
)
from .sampler import GuidanceConfig, RepellencyWindow, sample_sd, sample_sd3

__all__ = ["ERASE_SPECS", "SLD_CONFIGS", "SLD_SAFETY_CONCEPT", "EraseSpec", "PendingGeneration",
           "SafeDiffusionPipeline", "postprocess_image_host",
           "GuidanceConfig", "RepellencyWindow", "sample_sd", "sample_sd3"]
