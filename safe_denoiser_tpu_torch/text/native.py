"""ctypes binding for the native C++ BPE engine (native/bpe_tokenizer.cpp).

Counterpart of ``safe_denoiser_tpu/text/native.py`` on the same
framework-free source. The shared library is built on demand with g++ into
``build/bpe/libsdtbpe-<digest>.so`` at the root of the checkout (listed in
``.gitignore``; the digest covers the source and the flags, so an edited
source is rebuilt). The build writes a temporary file and renames it into
place, so concurrent processes never load a half-written library, and the
JAX package's own ``native/libsdtbpe.so`` is never touched. The Python
implementation in ``clip_tokenizer.py`` is the reference semantics; the
engine's ids equal it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "bpe_tokenizer.cpp"
BUILD_DIR = _ROOT / "build" / "bpe"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"libsdtbpe-{digest}.so"


def ensure_built() -> Path:
    """The engine's library, built first if needed; raises
    ``RuntimeError`` with g++'s message when it cannot be built."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC}:\n{r.stderr}")
        os.replace(tmp, out)
    except FileNotFoundError:
        raise RuntimeError("native BPE engine unavailable: no g++") from None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class NativeBPE:
    """Native encode() with the same id stream as CLIPTokenizer.encode."""

    def __init__(self, vocab: dict[str, int], merges):
        self._lib = ctypes.CDLL(str(ensure_built()))
        self._lib.sdt_bpe_create.restype = ctypes.c_void_p
        self._lib.sdt_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        self._lib.sdt_bpe_encode.restype = ctypes.c_int32
        self._lib.sdt_bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        self._lib.sdt_bpe_destroy.argtypes = [ctypes.c_void_p]

        # The engine assigns line-index ids; remap to the true (possibly
        # non-dense) vocab ids on the way out.
        by_id = sorted(vocab.items(), key=lambda kv: kv[1])
        self._remap = [tid for _, tid in by_id]
        vocab_blob = "\n".join(tok for tok, _ in by_id).encode("utf-8")
        merges_blob = "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8")
        self._handle = self._lib.sdt_bpe_create(vocab_blob, merges_blob)

    def encode(self, text: str, max_out: int = 4096) -> list[int]:
        buf = (ctypes.c_int32 * max_out)()
        n = self._lib.sdt_bpe_encode(self._handle, text.encode("utf-8"),
                                     buf, max_out)
        return [self._remap[i] for i in buf[:n]]

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.sdt_bpe_destroy(handle)
