"""Bank-sharded repellency: the negative bank's M rows split over the slots
of a mesh axis, each slot's raw partials summed across the axis.

Counterpart of ``safe_denoiser_tpu/parallel/bank.py``. Each slot holds an
M/n shard of the bank and computes, with the replicated path's kernel in
its raw form (``ops.repellency_kernels.rbf_negative_score(...,
normalize=False)``, B2 on a CUDA tensor),

    num_i^(k) = sum_{j in shard k} w_ij r_j        beta_i^(k) = sum_j w_ij

then ``comm.psum`` adds the slots' partials in slot order, and epsilon and
the division come once afterwards: the replicated result up to the f32
order of the sums. The sparse (SPELL) force does the same with its raw
partials (sum c r, sum c).

A sharded bank is the list of its shards, one per slot of the axis
(:func:`shard_bank`); the functions also take a whole [M, D] bank, M a
multiple of the axis size, and shard it. ``batch_axis`` splits x's rows
over a second axis, as on JAX's (data, model) mesh: row block i runs on the
bank axis's slots at ``batch_axis = i``. Inside a data-parallel loop that
already fixed ``batch_axis`` (``mesh.over_axis``), x is that row block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.repellency_kernels import (rbf_negative_score,
                                      sparse_repellency_force)
from . import comm
from .mesh import Mesh, current_coords, on_slot, slot_coords, split_rows

# Pad rows sit ~1e10 from any real latent: exp(-d/2 sigma^2) underflows to
# exactly 0.0, and for the sparse method the row is far outside any radius,
# so its truncated weight is exactly 0.0 too. (A 0.0 pad would contribute
# w = exp(-||x||/2 sigma^2) > 0; 1e30 overflows r^2 to inf and makes num
# 0 * inf = NaN.)
PAD_VALUE = 1e10


def pad_bank(refs: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The bank's M axis padded to a multiple of ``n_shards`` with
    PAD_VALUE rows (exact no-ops in the score and the force)."""
    m = refs.shape[0]
    m_pad = -(-m // n_shards) * n_shards
    if m_pad == m:
        return refs
    return torch.cat([refs, refs.new_full((m_pad - m, *refs.shape[1:]),
                                          PAD_VALUE)])


def shard_bank(refs: torch.Tensor, mesh: Mesh, axis: str = "data") -> list:
    """The [M, ...] bank padded and split over ``axis``: one shard a slot,
    on its device."""
    devs = mesh.line(axis)
    return [s.to(d) for s, d in zip(
        split_rows(pad_bank(refs, len(devs)), len(devs)), devs)]


def _shards(refs, mesh: Mesh, axis: str) -> list:
    if isinstance(refs, (list, tuple)):
        if len(refs) != mesh.shape[axis]:
            raise ValueError(f"{len(refs)} bank shards for an axis of "
                             f"{mesh.shape[axis]} slots")
        return list(refs)
    return shard_bank(refs, mesh, axis)


def _row_blocks(x: torch.Tensor, mesh: Mesh, batch_axis: Optional[str]):
    """(coordinates, rows) blocks of x: one block unless ``batch_axis``
    splits x and no caller fixed it already."""
    if batch_axis is None or batch_axis in current_coords():
        return [({}, x)]
    n = mesh.shape[batch_axis]
    return [({batch_axis: i}, rows)
            for i, rows in enumerate(split_rows(x, n))]


def _sharded_partials(partial_fn, x, refs, mesh, axis, batch_axis):
    """Per row block: ``partial_fn(rows, shard)`` on every slot of ``axis``
    (two tensors), each summed across the axis; the blocks' sums
    concatenated on x's device."""
    shards = _shards(refs, mesh, axis)
    firsts, seconds = [], []
    for coords, rows in _row_blocks(x, mesh, batch_axis):
        with slot_coords(**coords):
            devs = mesh.line(axis)
            parts = []
            for d, s in zip(devs, shards):
                with on_slot(d):
                    parts.append(partial_fn(rows.to(d), s.to(d)))
        firsts.append(comm.psum([p[0] for p in parts], devs)[0].to(x.device))
        seconds.append(comm.psum([p[1] for p in parts], devs)[0].to(x.device))
    return torch.cat(firsts), torch.cat(seconds)


def sharded_negative_score(x: torch.Tensor, refs, sigma: float,
                           epsilon: float = 1e-8, *, mesh: Mesh,
                           axis: str = "data",
                           batch_axis: Optional[str] = None):
    """The bank-sharded ``rbf_negative_score``: x [N, D] against the bank
    (shards, or a whole [M, D] bank with M a multiple of the axis size).
    Returns (score [N, D], beta [N]) on x's device."""
    num, beta = _sharded_partials(
        lambda rows, shard: rbf_negative_score(rows, shard, sigma,
                                               normalize=False),
        x, refs, mesh, axis, batch_axis)
    beta = beta + epsilon
    return num / beta[:, None], beta


def sharded_sparse_force(x: torch.Tensor, refs, radius: float, *,
                         mesh: Mesh, axis: str = "data",
                         batch_axis: Optional[str] = None):
    """The bank-sharded ``sparse_repellency_force`` from the summed raw
    partials (sum c r, sum c): force = x sum c - sum c r."""
    cr, c_sum = _sharded_partials(
        lambda rows, shard: sparse_repellency_force(rows, shard, radius,
                                                    raw=True),
        x, refs, mesh, axis, batch_axis)
    return x.float() * c_sum[:, None] - cr, c_sum


@dataclasses.dataclass(frozen=True)
class ShardedBank:
    """Bank-sharded stand-ins for the repellency kernels with their
    signatures, passed as ``apply_repellency(..., bank=)`` and threaded
    through the samplers as ``rep_bank=``; the bank goes through
    ``shard_bank`` (same mesh and axis) before the loop."""

    mesh: Mesh
    axis: str = "data"
    batch_axis: Optional[str] = None

    def score(self, x, refs, sigma, epsilon=1e-8):
        return sharded_negative_score(
            x, refs, sigma, epsilon, mesh=self.mesh, axis=self.axis,
            batch_axis=self.batch_axis)

    def sparse_force(self, x, refs, radius):
        return sharded_sparse_force(
            x, refs, radius, mesh=self.mesh, axis=self.axis,
            batch_axis=self.batch_axis)

    def single_device(self) -> bool:
        """True when every slot lies on one device (a CUDA graph can hold
        the loop)."""
        return len(self.mesh.distinct_devices()) == 1
