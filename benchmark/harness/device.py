"""The yardstick's device arithmetic: the card's published peaks, the least
time the card could take for a kernel, the operations and bytes of the
kernels the rooflines read, reckoned from their shapes alone, and a
kernel's share of its roofline in the traced stretch.

``bound_ms`` is a copy of ``chip_smoke.py``'s (where the port's kernel
table was measured); the counts are the port's kernel tables'
(``PERF.md``): attention 4·B·H·S²·D operations, the fused 3x3 conv
2·B·H·W·9·Ci·Co.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense (no sparsity), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the peak."""
    return max(n_bytes / PEAK_BYTES, n_ops / peak_ops) * 1e3


def attention_ops(b: int, s: int, h: int, d: int) -> int:
    """Two [S, S, D] products per head."""
    return 4 * b * h * s * s * d


def attention_bytes(b: int, s: int, h: int, d: int, width: int = 2) -> int:
    """q, k and v read once, the output written once."""
    return 4 * b * s * h * d * width


def conv3x3_ops(b: int, h: int, w: int, ci: int, co: int) -> int:
    """A K = 9·Ci product per output pixel."""
    return 2 * b * h * w * 9 * ci * co


def conv3x3_bytes(b: int, h: int, w: int, ci: int, co: int,
                  residual: bool, width: int = 2) -> int:
    """The input, the weights and the output once; the residual once when
    the call adds one."""
    pixels = b * h * w
    return width * (pixels * ci + 9 * ci * co + pixels * co
                    * (2 if residual else 1))


def trace_roofline(run, counter: str, pattern: str, calls: list):
    """Share (%) of its roofline that a kernel reached in the traced
    stretch of the cell's own traffic: its launches there, as the program's
    launch counter ``counter`` read them, each worth the mean bound of a
    call of the cell's shape table ``calls`` [(bound_ms, calls a batch)],
    over the device time of the trace's kernels whose name holds
    ``pattern``. The stretch runs whole batches, so the mean is exact.
    None where the stretch launched none, or where the trace's kernels and
    the counter disagree (the kernel is no longer the op's)."""
    t = run.trace or {}
    launches = (t.get("launches") or {}).get(counter, 0)
    hits = [(c, sec) for name, (c, sec) in (t.get("kernels") or {}).items()
            if pattern in name]
    seen, seconds = sum(c for c, _ in hits), sum(s for _, s in hits)
    run.log(f"{counter}: {launches} launches counted, {seen} kernels "
            f"{pattern!r} in the trace, {seconds:.6f} s")
    per_batch = sum(n for _, n in calls)
    if not launches or not per_batch or seen != launches or seconds <= 0:
        return None
    bound = sum(b * n for b, n in calls) / per_batch * launches
    return 100.0 * bound / (seconds * 1e3)
