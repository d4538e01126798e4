"""The cross-slot operations: the port's counterparts of the collectives
XLA inserts under ``shard_map`` (``jax.lax.psum``, ``all_gather``,
``pmax``, ``ppermute``). Nothing else in the port moves data between the
slots of a mesh.

Each takes one tensor per slot, in slot order, and the slots' devices
(default: where each tensor lies). Reductions run in slot order on the
first slot's device -- ((p0 + p1) + p2) + ... -- and the one result is
copied back to each slot, so every slot holds the same bits and two runs
agree. Copies to a slot on the same device are the tensor itself. All of
them are differentiable (``Tensor.to`` and the arithmetic are).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _devices(parts, devices):
    return [p.device for p in parts] if devices is None else list(devices)


def _hand_back(t: torch.Tensor, devices: Sequence[torch.device]) -> list:
    """``t`` on each of ``devices``: one copy per distinct device."""
    copies: dict[str, torch.Tensor] = {}
    out = []
    for dev in devices:
        key = str(dev)
        if key not in copies:
            copies[key] = t.to(dev)
        out.append(copies[key])
    return out


def psum(parts: Sequence[torch.Tensor],
         devices: Optional[Sequence[torch.device]] = None) -> list:
    """The sum of the slots' tensors, in slot order, on every slot."""
    devices = _devices(parts, devices)
    total = parts[0].to(devices[0])
    for p in parts[1:]:
        total = total + p.to(devices[0])
    return _hand_back(total, devices)


def pmax(parts: Sequence[torch.Tensor],
         devices: Optional[Sequence[torch.device]] = None) -> list:
    """The elementwise maximum of the slots' tensors, on every slot."""
    devices = _devices(parts, devices)
    out = parts[0].to(devices[0])
    for p in parts[1:]:
        out = torch.maximum(out, p.to(devices[0]))
    return _hand_back(out, devices)


def all_gather(parts: Sequence[torch.Tensor], dim: int = 0,
               devices: Optional[Sequence[torch.device]] = None) -> list:
    """The slots' tensors concatenated along ``dim`` in slot order (JAX's
    ``all_gather(..., tiled=True)``), on every slot."""
    devices = _devices(parts, devices)
    full = torch.cat([p.to(devices[0]) for p in parts], dim)
    return _hand_back(full, devices)


def ppermute(parts: Sequence[Optional[torch.Tensor]],
             perm: Sequence[tuple[int, int]],
             devices: Sequence[torch.device]) -> list:
    """Slot ``dst`` receives slot ``src``'s tensor for each (src, dst) of
    ``perm``; a slot that receives nothing, or a None, holds None (JAX's
    ppermute gives it zeros: the pipeline schedule never reads them)."""
    out: list = [None] * len(devices)
    for src, dst in perm:
        if parts[src] is not None:
            out[dst] = parts[src].to(devices[dst])
    return out
