"""Helpers the per-layer metric readers (``metrics/<name>.py``) share.
Each reader's ``read(run)`` returns a number, or None where its cell gives
it nothing to read."""

from __future__ import annotations


def stage_mean(run, stage: str):
    """Mean ``PendingGeneration.stage_ms[stage]`` (CUDA events) over the
    window's batches."""
    vals = [r["stage_ms"][stage] for r in getattr(run.load, "records", [])
            if stage in r["stage_ms"]]
    return sum(vals) / len(vals) if vals else None


def idle_share(run):
    """Share (%) of the traced stretch with no operation on the device."""
    t = run.trace or {}
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
