"""Benchmark runners (CLI entry points): ``python -m
safe_denoiser_tpu_torch.runners.nudity``."""
