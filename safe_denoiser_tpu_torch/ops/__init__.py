"""The port's kernels, each beside its plain PyTorch version.

| kernel     | module                 | route  | replaces (JAX package)                     |
| ---------- | ---------------------- | ------ | ------------------------------------------ |
| attention  | ops/attention.py       | CUDA   | ops/attention.py::_attn_kernel             |
| rbf        | ops/repellency_kernels | CUDA   | ops/repellency_kernels.py::_rbf_kernel     |
| conv3x3_up | ops/conv3x3.py         | CUDA   | ops/conv3x3.py::_up_kernel_planar          |
| gn_stats   | ops/group_norm.py      | Triton | ops/group_norm.py::_gn_stats_kernel        |

Each wrapper counts its launches in a module-level ``launches`` integer.
"""

from __future__ import annotations

from . import attention, conv3x3, group_norm, repellency_kernels

KERNEL_MODULES = {
    "attention": attention,
    "rbf": repellency_kernels,
    "conv3x3_up": conv3x3,
    "gn_stats": group_norm,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
