"""Share (%) of its roofline that the fused 3x3 conv (B4) reached in the
traced stretch."""

from benchmark.harness import device as dev


def read(run):
    """The same over the traced stretch's launches of ``ops.conv3x3.
    conv3x3`` (the kernels ``conv_kernel<false>`` in the trace): the VAE
    decoder's resnet convs with their GroupNorm affine, SiLU and (conv2)
    residual."""
    rows = []
    for b, h, w, ci, co, residual, n in run.system.conv3x3_calls():
        bound = dev.bound_ms(dev.conv3x3_bytes(b, h, w, ci, co, residual),
                             dev.conv3x3_ops(b, h, w, ci, co))
        run.log(f"conv3x3 [{b},{h},{w},{ci}]->{co} residual={residual} "
                f"x{n} a batch: bound {bound:.4f} ms")
        rows.append((bound, n))
    return dev.trace_roofline(run, "conv3x3", "conv_kernel<false>", rows)
