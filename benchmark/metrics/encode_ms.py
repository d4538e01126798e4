"""The pipeline's text encode a batch, ``PendingGeneration.stage_ms
["encode"]`` (CUDA events), mean over the window's batches."""

from benchmark.harness.readers import stage_mean


def read(run):
    return stage_mean(run, "encode")
