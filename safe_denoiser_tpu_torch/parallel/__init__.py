"""The parallel layer in one process: meshes of device slots, batch
sharding, bank-sharded repellency, sequence-, tensor- and
pipeline-parallel MMDiT/UNet.

Counterpart of ``safe_denoiser_tpu/parallel/``. Where the JAX layer is one
process over a device mesh with XLA's collectives, this one runs a kernel
call per slot and moves data between slots only in ``comm.py`` (sums in
slot order, so results are deterministic). Slots may repeat a device (the
CPU tests, one GPU); ``make_mesh(n)`` without ``devices=`` needs n GPUs.
"""

from .bank import (PAD_VALUE, ShardedBank, pad_bank, shard_bank,
                   sharded_negative_score, sharded_sparse_force)
from .mesh import (Mesh, make_mesh, over_axis, replicate, shard_batch,
                   slot_coords)
from .pp import pp_blocks, shard_stacked_pp, stack_block_params
from .sp import constrain_seq, sp_joint_attention
from .tp import MMDIT_TP_RULES, UNET_TP_RULES, shard_params_tp, tp_layout

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "over_axis",
           "slot_coords", "shard_params_tp", "tp_layout", "MMDIT_TP_RULES",
           "UNET_TP_RULES", "constrain_seq", "sp_joint_attention",
           "pp_blocks", "stack_block_params", "shard_stacked_pp",
           "PAD_VALUE", "pad_bank", "shard_bank", "sharded_negative_score",
           "sharded_sparse_force", "ShardedBank"]
