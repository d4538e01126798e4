from .diffusion import (
    ERASE_SPECS,
    EraseSpec,
    PendingGeneration,
    SafeDiffusionPipeline,
    postprocess_image_host,
)
from .sampler import GuidanceConfig, RepellencyWindow, sample_sd, sample_sd3

__all__ = ["ERASE_SPECS", "EraseSpec", "PendingGeneration",
           "SafeDiffusionPipeline", "postprocess_image_host",
           "GuidanceConfig", "RepellencyWindow", "sample_sd", "sample_sd3"]
