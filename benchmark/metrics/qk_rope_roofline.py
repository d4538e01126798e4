"""Share (%) of its roofline that FLUX's fused qk-RMSNorm + rotary
(``ops.qk_rope``) reached in the traced stretch."""

from benchmark.harness import device as dev

# the tables' f32 operations an element of q or k: the square and its sum,
# the scale and the weight, the rotary's four products and two sums
OPS_PER_VALUE = 10
PEAK_F32_FLOPS = 67e12      # H100 SXM, outside the tensor cores


def qk_rope_bytes(b: int, segments: tuple, h: int, d: int,
                  width: int = 2) -> int:
    """q and k read and written once; v read and written once where two
    segments are joined (the launch copies v into the joint buffer); the
    four (two) [D] norm weights; the f32 cos and sin tables [S, D]."""
    s = sum(segments)
    row = b * s * h * d * width
    tensors = 3 if len(segments) > 1 else 2
    return 2 * tensors * row + 2 * len(segments) * d * width + 2 * s * d * 4


def read(run):
    """Σ bound over Σ device time (%) of the traced stretch's launches of
    ``ops.qk_rope`` (the kernels ``sdt_qkrope::qk_rope_kernel`` in the
    trace), each launch worth the mean bound of the cell's qk_rope calls:
    max(bytes / bandwidth, f32 operations / the f32 peak)."""
    calls = getattr(run.system, "qk_rope_calls", None)
    if calls is None:
        return None
    rows = []
    for b, segments, h, d, n in calls():
        ops = OPS_PER_VALUE * 2 * b * sum(segments) * h * d
        bound = dev.bound_ms(qk_rope_bytes(b, segments, h, d), ops,
                             PEAK_F32_FLOPS)
        run.log(f"qk_rope [{b},{'+'.join(map(str, segments))},{h},{d}] "
                f"x{n} a batch: bound {bound:.4f} ms")
        rows.append((bound, n))
    return dev.trace_roofline(run, "qk_rope", "qk_rope_kernel<", rows)
