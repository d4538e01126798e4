"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, one ``nvcc`` per source, all started together, into
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``). A library's file name carries a hash of its source and of
the shared headers (``csrc/*.cuh``), so an edited source or header is
rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU test host has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("attention", "attention_i8", "rbf", "conv3x3_up", "conv3x3",
           "attention_nt", "attention_bshd", "repack_heads",
           "conv3x3_up_interleave", "group_norm", "attention_bwd",
           "conv3x3_up_bwd", "adaln")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ATTN = [_P] * 4 + [_I] * 4 + [_L] * 3 + [_F, _P]
_LAYOUT = [_P] * 4 + [_I] * 4 + [_F, _P]       # nt and bshd attention
_REPACK = [_P] * 2 + [_I] * 5 + [_P]
# argument types of each C entry point (all return an int: a cudaError_t,
# or for the *_smem entries a kernel's dynamic shared memory in bytes),
# bound once when its library is loaded
SIGNATURES = {
    "attention": {"sdt_self_attention_bf16": _ATTN,
                  "sdt_self_attention_f32": _ATTN,
                  "sdt_self_attention_bf16_smem": [_I],
                  "sdt_self_attention_lse_bf16": [_P] * 5 + [_I] * 4
                  + [_L] * 3 + [_F, _I, _P]},
    "attention_i8": {
        "sdt_self_attention_i8_bf16":
            [_P] * 7 + [_I] * 4 + [_L] * 3 + [_F, _F, _P],
        "sdt_quantize_i8_bf16": [_P] * 5 + [_I] * 4 + [_L] * 3 + [_F, _F, _P],
        "sdt_attention_i8_quantized_bf16": [_P] * 5 + [_I] * 4 + [_L] * 3
        + [_P],
        "sdt_self_attention_i8_bf16_smem": [_I]},
    "rbf": {"sdt_rbf_score_f32": [_P] * 5 + [_I] * 3 + [_F, _F] + [_I] * 7
            + [_P]},
    "group_norm": {"sdt_group_norm_fused": [_P] * 4 + [_I] * 11
                   + [_F, _I, _I, _P]},
    "conv3x3_up": {"sdt_conv3x3_up_bf16": [_P] * 4 + [_I] * 5 + [_P],
                   "sdt_conv3x3_up_bf16_smem": []},
    "conv3x3_up_interleave": {
        "sdt_conv3x3_up_interleave_bf16": [_P] * 4 + [_I] * 5 + [_P],
        "sdt_conv3x3_up_interleave_bf16_smem": []},
    "conv3x3": {"sdt_conv3x3_bf16": [_P] * 7 + [_I] * 6 + [_P],
                "sdt_conv3x3_bf16_smem": []},
    "attention_nt": {"sdt_attention_nt_bf16": _LAYOUT,
                     "sdt_attention_nt_f32": _LAYOUT},
    "attention_bshd": {"sdt_attention_bshd_bf16": _LAYOUT,
                       "sdt_attention_bshd_f32": _LAYOUT},
    "repack_heads": {"sdt_repack_to_heads": _REPACK,
                     "sdt_repack_from_heads": _REPACK},
    "attention_bwd": {"sdt_attention_bwd_bf16": [_P] * 10 + [_I] * 5
                      + [_F, _P]},
    "conv3x3_up_bwd": {
        "sdt_conv3x3_up_bwd_dx_bf16": [_P] * 3 + [_I] * 5 + [_P],
        "sdt_conv3x3_up_bwd_dx_plan": [_I] * 5,
        "sdt_conv3x3_up_bwd_fold": [_P] * 2 + [_I] * 3 + [_P],
        "sdt_conv3x3_up_bwd_dx_tiled": [_P] * 3 + [_I] * 7 + [_P],
        "sdt_conv3x3_up_bwd_dx_clusters": [_I] * 2,
        "sdt_conv3x3_up_bwd_dw_bf16": [_P] * 4 + [_I] * 5 + [_P]},
    "adaln": {"sdt_adaln": [_P, _L, _L] * 2 + [_P, _L] * 3 + [_P] * 2
              + [_I] * 5 + [_F, _P]},
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing; returns the seconds
    taken (0 when all were built already). Raises with nvcc's output when a
    build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    procs = {}
    if todo:
        nvcc = _nvcc()
        for name in todo:
            out = _lib_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{stdout}{stderr}")
        else:
            out.with_suffix(".ptxas").write_text(stderr)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v report of ``csrc/<name>.cu``, kept beside its
    library by the build that made it ("" if it is not built)."""
    kept = _lib_path(name).with_suffix(".ptxas")
    return kept.read_text() if kept.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    its entry points' signatures bound."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require_current(device) -> None:
    """Raise unless ``device`` is the current CUDA device: a kernel runs on
    the current device, so a tensor of another one (a mesh slot's, outside
    ``parallel.mesh.on_slot``) would be launched on the wrong device or
    missed by a CUDA graph's capture."""
    import torch
    device = torch.device(device)
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(
            f"a kernel on {device} while cuda:{current} is the current "
            f"device: run it under torch.cuda.device({device.index})")


def stream_ptr(device) -> int:
    """The current stream of ``device``, which must be the current
    device."""
    import torch
    require_current(device)
    return torch.cuda.current_stream(device).cuda_stream


# devices whose tensors the kernel wrappers hand to their plain versions
_PLAIN_DEVICES = {"cpu"}


def takes_plain(t) -> bool:
    """Whether a kernel wrapper takes its plain PyTorch version for tensor
    ``t``: a CPU tensor always, a ``meta`` tensor only inside
    ``plain_on_meta()``, a CUDA tensor never (it launches the kernel or
    raises)."""
    return t.device.type in _PLAIN_DEVICES


@contextlib.contextmanager
def plain_on_meta():
    """Inside the block the kernel wrappers take their plain versions for
    ``meta`` tensors as well, so a forward traces on shapes alone (the
    model-FLOP count, ``utils/flops.py``). Restored on exit."""
    saved = set(_PLAIN_DEVICES)
    _PLAIN_DEVICES.add("meta")
    try:
        yield
    finally:
        _PLAIN_DEVICES.clear()
        _PLAIN_DEVICES.update(saved)
