"""Benchmark runners (CLI entry points): ``python -m
safe_denoiser_tpu_torch.runners.nudity``, ``.sdv3``, ``.artist
{ann_graham,munch}`` and ``.copro``."""
