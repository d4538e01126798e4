"""safe_denoiser_tpu_torch — the PyTorch/CUDA port of ``safe_denoiser_tpu``.

Runs the SD-v1.4 safe-denoiser generation path (CLIP tokenize + encode, a
DDPM UNet loop with CFG and ``kernel_fast`` repellency, VAE decode) and
the SD3-medium one (CLIP-L + CLIP-bigG + T5-XXL encode, SAFREE, a
flow-match MMDiT loop with the renoising repellency, VAE decode), with
optional W8A8 int8, all six repellency methods, the nudity, artist, CoPro
and COCO-30k runners with their NudeNet and Q16 gates and the in-loop
CLIPScore, the offline FID/KID/IS/CLIPScore/AES evaluators, and serving
(``serving/``: a dynamic batcher behind an HTTP server and the deployment
bundle; ``runners/serve.py``), with the sampling loop and the decode
replayed from CUDA graphs (``pipeline/graph.py``), on one NVIDIA Hopper
GPU.
Module paths mirror the JAX package so each counterpart is easy to find;
the JAX package stays the numerical reference.

Plain tensor code is PyTorch. The six Pallas kernels on these paths have
hand-written Hopper counterparts under ``csrc/`` (CUDA C++) and
``ops/group_norm.py`` (Triton); each sits beside a plain PyTorch version
that CPU tensors take. Nothing here imports ``jax`` or the JAX package.
"""

__version__ = "0.1.0"
