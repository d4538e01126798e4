"""Random checkpoints drawn on the device from the run's seed.

A configuration's file names each component, its reference module (which
lists the checkpoint's tensors: ``reference/<module>.param_spec``), the
dtype it is served in and its initialisation rule. Each component is drawn
with one ``torch.Generator`` on the device, in a few large ``randn`` calls
into one flat buffer per dtype, and every tensor is a view of that buffer,
scaled in place: "torch_default" gives matrices and biases PyTorch's
default variance (that of U(-1/sqrt(fan_in), 1/sqrt(fan_in))) and
embeddings N(0, 1); "small" gives every tensor of two or more dims
N(0, std^2) (the scale that keeps SD3's towers finite in bf16) and biases
the default variance. Norm weights are ones and norm biases zeros.

The same seed gives the same tensors, bit for bit, so the program and the
reference are handed the same checkpoint.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_CHUNK = 1 << 28           # elements a randn call draws
_ALIGN = 64                # elements: every tensor starts 128-byte aligned


def component_spec(name: str, comp: dict) -> list:
    """(name, shape, kind, fan_in) of every tensor of a component."""
    module = importlib.import_module(f"benchmark.reference.{comp['module']}")
    return module.param_spec(comp)


def stream_seed(seed: int, index: int) -> int:
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), index])
    lo, hi = state.generate_state(2, np.uint32)
    return (int(hi) << 31) | (int(lo) >> 1)


def _std(kind: str, fan_in: int, init: dict):
    if kind in ("ones", "zeros"):
        return None
    if init["rule"] == "small" and kind in ("matrix", "embedding"):
        return float(init["std"])
    if kind == "embedding":
        return 1.0
    return 1.0 / math.sqrt(3.0 * fan_in)


def draw_component(name: str, comp: dict, seed: int, index: int,
                   device) -> dict:
    """The component's tensors by name, in its serving dtype."""
    dtype = DTYPES[comp["dtype"]]
    spec = component_spec(name, comp)
    offsets, total = [], 0
    for _, shape, kind, _ in spec:
        offsets.append(total)
        if kind not in ("ones", "zeros"):
            total += -(-math.prod(shape) // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  index))
    flat = torch.empty(total, dtype=dtype, device=device)
    for start in range(0, total, _CHUNK):
        n = min(_CHUNK, total - start)
        flat[start:start + n] = torch.randn(n, generator=gen, dtype=dtype,
                                            device=device)
    out = {}
    for (key, shape, kind, fan_in), off in zip(spec, offsets):
        std = _std(kind, fan_in, comp["init"])
        if std is None:
            fill = torch.ones if kind == "ones" else torch.zeros
            out[key] = fill(shape, dtype=dtype, device=device)
            continue
        t = flat[off:off + math.prod(shape)].view(shape)
        out[key] = t.mul_(std)
    return out


def draw_checkpoint(cfg: dict, seed: int, device, only=None) -> dict:
    """component -> tensors for every component of ``cfg`` (or those in
    ``only``), each from its own stream of ``seed``."""
    return {name: draw_component(name, comp, seed, i, device)
            for i, (name, comp) in enumerate(cfg["components"].items())
            if only is None or name in only}
