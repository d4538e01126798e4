"""Sequence-parallel joint attention: the image tokens split over a ``seq``
mesh axis.

Counterpart of ``safe_denoiser_tpu/parallel/sp.py``. ``constrain_seq`` cuts
a [B, S, ...] activation into one token slice a slot; the MMDiT's
pointwise block math (AdaLN, projections, MLP) then runs on each slot's
slice, and the one op with global extent, the joint attention, is
``sp_joint_attention``: each slot keeps its queries, the image K/V go
through ``comm.all_gather``, the context K/V (replicated: 154/333 text
tokens do not divide over the axis) are concatenated after them, and the
context queries are attended on every slot. The image output stays split;
the context output is the same on every slot.

As in the JAX package, the attention there has more keys than queries, so
``layers.dot_product_attention`` takes the plain einsum form, not B1.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comm
from .mesh import Mesh, on_slot, split_rows


def constrain_seq(x: torch.Tensor, mesh: Optional[Mesh],
                  seq_axis: str = "seq", data_axis: str = "data",
                  seq_dim: int = 1):
    """A [B, S, ...] activation cut along ``seq_dim`` into one slice per
    slot of ``seq_axis``, each on its slot's device (x itself without a
    mesh). The rows of ``data_axis`` are the caller's
    (``mesh.over_axis``)."""
    if mesh is None:
        return x
    devs = mesh.line(seq_axis)
    return [p.to(d) for p, d in zip(split_rows(x, len(devs), seq_dim),
                                    devs)]


def sp_joint_attention(xq, xk, xv, cq, ck, cv, mesh: Mesh,
                       seq_axis: str = "seq", data_axis: str = "data"):
    """MMDiT joint attention with the image tokens split over ``seq_axis``.

    Image q/k/v: [B, S, H, D] tensors (split here) or lists of one slice a
    slot; context q/k/v: tensors (copied to each slot) or lists of one
    copy a slot. Returns (out_img: one [B, S/n, H, D] slice a slot,
    out_ctx: one [B, S_ctx, H, D] copy a slot) -- the values of attention
    over concat([img, ctx])."""
    from ..models.layers import dot_product_attention

    devs = mesh.line(seq_axis)
    if torch.is_tensor(xq):
        xq, xk, xv = (constrain_seq(t, mesh, seq_axis, data_axis)
                      for t in (xq, xk, xv))
    if torch.is_tensor(cq):
        cq, ck, cv = ([t.to(d) for d in devs] for t in (cq, ck, cv))
    k_img = comm.all_gather(xk, 1, devs)
    v_img = comm.all_gather(xv, 1, devs)
    out_img, out_ctx = [], []
    for s, dev in enumerate(devs):
        with on_slot(dev):
            k = torch.cat([k_img[s], ck[s]], 1)
            v = torch.cat([v_img[s], cv[s]], 1)
            out_img.append(dot_product_attention(xq[s], k, v))
            # a few hundred context queries: recomputed on every slot
            # rather than gathered
            out_ctx.append(dot_product_attention(cq[s], k, v))
    return out_img, out_ctx
