"""Share (%) of the traced stretch of a batch cell with no operation on the
device (``torch.profiler``)."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run)
