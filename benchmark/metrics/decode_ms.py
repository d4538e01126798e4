"""The VAE decode a batch (its CUDA graph replay), ``PendingGeneration.
stage_ms["decode"]``, mean over the window's batches."""

from benchmark.harness.readers import stage_mean


def read(run):
    return stage_mean(run, "decode")
