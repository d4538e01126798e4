"""The port's kernels, each beside its plain PyTorch version.

| kernel                | module             | route  | replaces (JAX package)                 |
| --------------------- | ------------------ | ------ | -------------------------------------- |
| attention             | ops/attention.py   | CUDA   | ops/attention.py::_attn_kernel         |
| attention_i8          | ops/attention.py   | CUDA   | ::_attn_kernel(quant_i8=True)          |
| attention_nt          | ops/attention.py   | CUDA   | ::_attn_kernel_nt                      |
| attention_bshd        | ops/attention.py   | CUDA   | ::_attn_kernel_bshd                    |
| repack_to_heads       | ops/attention.py   | CUDA   | ::_repack_to_heads_kernel              |
| repack_from_heads     | ops/attention.py   | CUDA   | ::_repack_from_heads_kernel            |
| rbf                   | repellency_kernels | CUDA   | ops/repellency_kernels.py::_rbf_kernel |
| conv3x3_up            | ops/conv3x3.py     | CUDA   | ops/conv3x3.py::_up_kernel_planar      |
| conv3x3_up_interleave | ops/conv3x3.py     | CUDA   | ops/conv3x3.py::_up_kernel             |
| conv3x3               | ops/conv3x3.py     | CUDA   | ops/conv3x3.py::_kernel                |
| gn_stats              | ops/group_norm.py  | Triton | ops/group_norm.py::_gn_stats_kernel    |
| gn_fused              | ops/group_norm.py  | CUDA   | ops/group_norm.py::_gn_kernel          |

The port's own forward kernels, with no Pallas counterpart (the JAX
package leaves what they compute to XLA's fusion):

| kernel                | module             | route  | computes                               |
| --------------------- | ------------------ | ------ | -------------------------------------- |
| adaln                 | ops/adaln.py       | CUDA   | the MMDiT's gated residual + LayerNorm |
|                       |                    |        | + modulation, one pass over a row      |
| qk_rope               | ops/qk_rope.py     | CUDA   | FLUX's per-head RMSNorm + rotary on q  |
|                       |                    |        | and k into the joint attention buffers |

The backward kernels, the port's own (the JAX package's kernels have no
VJP; each computes the gradient of its forward's function):

| kernel                | module             | route  | backward of                            |
| --------------------- | ------------------ | ------ | -------------------------------------- |
| attention_bwd         | ops/attention.py   | CUDA   | attention (B1): dQ, dK, dV             |
| gn_stats_bwd          | ops/group_norm.py  | Triton | gn_stats (B5): dx                      |
| conv3x3_up_bwd_dx     | ops/conv3x3.py     | CUDA   | conv3x3_up (B3): dh                    |
| conv3x3_up_bwd_dw     | ops/conv3x3.py     | CUDA   | conv3x3_up (B3): dW, db                |

Every other kernel's CUDA wrapper raises under autograd (``ops/_grad.py``).

Each wrapper counts its launches in a module-level integer (``COUNTERS``),
where it launches its kernel. Under a CUDA graph (``pipeline/graph.py``) a
wrapper runs once, at capture, and its kernel launches at every replay: the
graph takes the counters' change over its warm-up and capture out again
(set-up, as a capture records and does not launch) and adds the change its
capture recorded at every replay, so a batch counts what it launched.
"""

from __future__ import annotations

from . import (adaln, attention, conv3x3, group_norm, qk_rope,
               repellency_kernels)

# kernel name -> (module, name of its launch counter there)
COUNTERS = {
    "attention": (attention, "launches"),
    "attention_i8": (attention, "i8_launches"),
    "attention_nt": (attention, "nt_launches"),
    "attention_bshd": (attention, "bshd_launches"),
    "repack_to_heads": (attention, "to_heads_launches"),
    "repack_from_heads": (attention, "from_heads_launches"),
    "rbf": (repellency_kernels, "launches"),
    "conv3x3_up": (conv3x3, "up_launches"),
    "conv3x3_up_interleave": (conv3x3, "interleave_launches"),
    "conv3x3": (conv3x3, "fused_launches"),
    "gn_stats": (group_norm, "launches"),
    "gn_fused": (group_norm, "fused_launches"),
    "adaln": (adaln, "launches"),
    "qk_rope": (qk_rope, "launches"),
}
# the backward kernels' counters, apart: sampling and serving never launch
# them (``backward_launch_counts``)
BACKWARD_COUNTERS = {
    "attention_bwd": (attention, "bwd_launches"),
    "gn_stats_bwd": (group_norm, "bwd_launches"),
    "conv3x3_up_bwd_dx": (conv3x3, "bwd_dx_launches"),
    "conv3x3_up_bwd_dw": (conv3x3, "bwd_dw_launches"),
}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in COUNTERS.items()}


def backward_launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in BACKWARD_COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every counter to 0, the backward kernels' too."""
    for mod, attr in (*COUNTERS.values(), *BACKWARD_COUNTERS.values()):
        setattr(mod, attr, 0)


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches, negative to take some out)
    to the counters."""
    for name, n in delta.items():
        mod, attr = COUNTERS.get(name) or BACKWARD_COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)
