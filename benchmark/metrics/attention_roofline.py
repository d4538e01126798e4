"""Share (%) of its roofline that the fused self-attention (B1) reached in
the traced stretch."""

from benchmark.harness import device as dev


def read(run):
    """Σ bound over Σ device time (%) of the traced stretch's launches of
    ``ops.attention.self_attention`` (the kernels ``sdt_attn::attn_kernel``
    in the trace), each launch worth the mean bound of the cell's
    attention shapes: max(4·B·H·S²·D / peak, bytes / bandwidth)."""
    rows = []
    for b, s, h, d, n in run.system.attention_calls():
        bound = dev.bound_ms(dev.attention_bytes(b, s, h, d),
                             dev.attention_ops(b, s, h, d))
        run.log(f"attention [{b},{s},{h},{d}] x{n} a batch: bound "
                f"{bound:.4f} ms")
        rows.append((bound, n))
    return dev.trace_roofline(run, "attention", "attn_kernel<", rows)
