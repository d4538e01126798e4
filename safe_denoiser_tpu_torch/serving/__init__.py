"""Serving layer: dynamic request batching, the HTTP front-end and the
deployment bundle (``aot.py``).

Counterpart of ``safe_denoiser_tpu/serving``: concurrent requests group
onto the GPU at a fixed batch size, whose sampling loop and decode replay
from CUDA graphs (``pipeline/graph.py``).
"""

from .batcher import DynamicBatcher, GenRequest
from .server import make_server

__all__ = ["DynamicBatcher", "GenRequest", "make_server"]
