"""Pipeline-parallel MMDiT block stack over a ``pipe`` mesh axis (GPipe).

Counterpart of ``safe_denoiser_tpu/parallel/pp.py``. The homogeneous
JointBlocks 0..L-2 (the last one is context_pre_only) are cut into
``pipe`` contiguous stages, padded with zero blocks to a multiple of the
stage count: a zero-parameter JointBlock is an exact identity (every
residual branch is scaled by an AdaLN-zero gate that a zero Linear
produces). Microbatches stream through the stages in the GPipe schedule,
M + S - 1 ticks with a ``comm.ppermute`` hop between stages after each;
the ticks' bubble slots compute nothing here (JAX computes junk there and
masks it). The special last block, the patchify prelude and the head run
outside the pipeline.

Where JAX stacks the blocks' parameters into [L, ...] leaves, the port
keeps a list of JointBlock modules (``stack_block_params``) and places each
stage's blocks on its slot's device (``shard_stacked_pp``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from . import comm
from .mesh import Mesh, module_on, on_slot, slot_coords, split_rows


def stack_block_params(model, num_layers: int, n_stages: int) -> list:
    """Blocks 0..num_layers-2 of an MMDiT (or a list of its blocks), padded
    with zero-parameter copies of block 0 so ``n_stages`` divides their
    count."""
    blocks = list(getattr(model, "transformer_blocks", model))
    blocks = blocks[:num_layers - 1]
    pad = (-len(blocks)) % n_stages
    if pad:
        zero = copy.deepcopy(blocks[0])
        with torch.no_grad():
            for p in zero.parameters():
                p.zero_()
        blocks += [zero] * pad
    return blocks


def shard_stacked_pp(stacked: list, mesh: Mesh,
                     pipe_axis: str = "pipe") -> list:
    """The stacked blocks cut into one contiguous stage a slot of
    ``pipe_axis``, each stage's blocks on its slot's device."""
    devs = mesh.line(pipe_axis)
    per = len(stacked) // len(devs)
    if per * len(devs) != len(stacked):
        raise ValueError(f"{len(stacked)} blocks over {len(devs)} stages: "
                         "pad with stack_block_params")
    return [[module_on(b, d) for b in stacked[k * per:(k + 1) * per]]
            for k, d in enumerate(devs)]


def _run_pipeline(stages: list, devs: list, xm, cm, em):
    """GPipe over the stages: microbatch m runs stage s at tick m + s."""
    n_micro, n_stages = len(xm), len(stages)
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    held: list = [None] * n_stages        # each stage's input this tick
    outs_x, outs_c = [None] * n_micro, [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:                   # stage 0 injects microbatch t
            held[0] = (xm[t].to(devs[0]), cm[t].to(devs[0]),
                       em[t].to(devs[0]))
        done: list = [None] * n_stages
        for s, state in enumerate(held):
            if state is None:
                continue                  # a bubble: nothing to compute
            xs, cs, es = state
            with on_slot(devs[s]):
                for blk in stages[s]:
                    xs, cs = module_on(blk, devs[s])(xs, cs, es)
            done[s] = (xs, cs, es)
        m = t - (n_stages - 1)
        if 0 <= m < n_micro:              # the last stage finished m
            outs_x[m], outs_c[m] = done[-1][0], done[-1][1]
        moved = [comm.ppermute([None if d is None else d[i] for d in done],
                               perm, devs) for i in range(3)]
        held = [None if moved[0][s] is None else
                (moved[0][s], moved[1][s], moved[2][s])
                for s in range(n_stages)]
    return outs_x, outs_c


def pp_blocks(cfg, stacked, x: torch.Tensor, context: torch.Tensor,
              emb: torch.Tensor, mesh: Mesh, n_micro: int, dtype=None,
              pipe_axis: str = "pipe", data_axis: Optional[str] = None):
    """The stacked homogeneous JointBlocks as a GPipe pipeline.

    x [B, S, D] image tokens, context [B, Sc, D], emb [B, D]; B divisible
    by ``n_micro``. ``stacked``: ``stack_block_params``'s list, or
    ``shard_stacked_pp``'s stages. ``data_axis`` splits each microbatch's
    rows over that axis (a pipeline a data slot). Returns (x, context) on
    x's device: per microbatch the values of applying the blocks in order.
    ``cfg`` and ``dtype`` are the JAX signature's (the blocks carry
    theirs)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} "
                         "microbatches")
    home = x.device
    devs = mesh.line(pipe_axis)
    if data_axis is None:
        stages = (stacked if stacked and isinstance(stacked[0], list)
                  else shard_stacked_pp(stacked, mesh, pipe_axis))
        ox, oc = _run_pipeline(stages, devs, x.chunk(n_micro),
                               context.chunk(n_micro), emb.chunk(n_micro))
        return (torch.cat([o.to(home) for o in ox]),
                torch.cat([o.to(home) for o in oc]))
    # microbatch m's rows split over the data slots: slot i pipelines the
    # i-th part of every microbatch
    n_data = mesh.shape[data_axis]
    parts = []
    for t in (x, context, emb):
        micro = t.reshape(n_micro, b // n_micro, *t.shape[1:])
        parts.append(split_rows(micro, n_data, dim=1))
    res_x, res_c = [], []
    for i in range(n_data):
        with slot_coords(**{data_axis: i}):
            rows = [p[i].reshape(-1, *p[i].shape[2:]) for p in parts]
            ox, oc = pp_blocks(cfg, stacked, *rows, mesh, n_micro, dtype,
                               pipe_axis, None)
        res_x.append(ox.reshape(n_micro, -1, *ox.shape[1:]))
        res_c.append(oc.reshape(n_micro, -1, *oc.shape[1:]))
    return (torch.cat(res_x, 1).reshape(x.shape),
            torch.cat(res_c, 1).reshape(context.shape))
