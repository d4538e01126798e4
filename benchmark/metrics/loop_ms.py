"""The sampling loop's device time a batch (the loop's CUDA graph replay),
``PendingGeneration.stage_ms["loop"]``, mean over the window's batches."""

from benchmark.harness.readers import stage_mean


def read(run):
    return stage_mean(run, "loop")
