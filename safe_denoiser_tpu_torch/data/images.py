"""Negative-image banks, with a PNG codec and PIL's BILINEAR and BICUBIC
resizes in numpy.

Counterpart of ``safe_denoiser_tpu/data/images.py``: the dataset registry
(nudity / inappropriate / artists), the sorted png+jpg glob under
``root/class_info`` with the 3,200-image cap, and the transform (resize to
size², scale to [-1, 1], NCHW f32). The machine with the GPU has no PIL,
so:

- PNG is decoded with ``zlib`` (8-bit gray, gray+alpha, RGB, RGBA and
  palette images, filters 0-4, not interlaced) and converted to RGB as
  PIL's ``convert("RGB")`` does (alpha dropped, gray repeated);
- the resizes reproduce ``Image.resize(..., Image.BILINEAR)`` and
  ``Image.BICUBIC`` exactly: a triangle or cubic (a = -0.5) filter whose
  support widens with the scale factor when shrinking, fixed-point
  coefficients of 22 bits, a horizontal pass then a vertical one, each
  rounded and clipped to uint8;
- a JPEG is decoded through PIL where PIL can be imported (as the JAX
  package reads it); without PIL it raises: decode the bank elsewhere, or
  give the run its projected bank as a ``.pt`` cache (``cache_proj_ref``).

``write_png`` is the runners' image writer (filter 0, one IDAT chunk);
``read_rgb`` reads any image file, PNG without PIL.
"""

from __future__ import annotations

import importlib
import math
import os
import struct
import zlib
from glob import glob
from typing import Callable, Optional

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples


# --------------------------------------------------------------------- PNG
def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG
    bytes, every row with filter 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"PNG writer takes 1, 3 or 4 channels, got {c}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * c)], axis=1).tobytes()
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter_row(ftype: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    if ftype == 0:
        return line
    if ftype == 1:
        a = np.frombuffer(line, np.uint8).reshape(-1, bpp)
        return np.cumsum(a, axis=0, dtype=np.uint8).tobytes()
    if ftype == 2:
        return (np.frombuffer(line, np.uint8)
                + np.frombuffer(prev, np.uint8)).tobytes()
    cur = bytearray(line)
    n = len(cur)
    if ftype == 3:
        for i in range(n):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        return bytes(cur)
    if ftype == 4:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
        return bytes(cur)
    raise ValueError(f"PNG filter type {ftype}")


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB, as PIL's ``convert("RGB")``."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} is not supported "
                         "(8-bit gray/gray+alpha/RGB/RGBA/palette, not "
                         "interlaced)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    rows, prev = [], bytes(stride)
    for y in range(h):
        off = y * (stride + 1)
        prev = _unfilter_row(raw[off], raw[off + 1:off + 1 + stride], prev,
                             bpp)
        rows.append(prev)
    img = np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[img[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


# ---------------------------------------------------------------- resizing
_PRECISION_BITS = 32 - 8 - 2          # Pillow's Resample.c


def _bilinear(x: float) -> float:
    return max(0.0, 1.0 - abs(x))


def _bicubic(x: float) -> float:
    """Pillow's cubic convolution kernel, a = -0.5."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coeffs(in_size: int, out_size: int, kernel, support: float
            ) -> np.ndarray:
    """[out, in] fixed-point weights of Pillow's resampling filter
    ``kernel`` (Resample.c's ``precompute_coeffs``): its support widened
    by the scale factor when shrinking, each row normalized to sum 1, then
    rounded half away from zero to ``_PRECISION_BITS`` bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    k = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(ws)
        for x, wv in enumerate(ws):
            wv = wv / total if total != 0.0 else wv
            k[xx, xmin + x] = int(wv * (1 << _PRECISION_BITS)
                                  + (0.5 if wv >= 0 else -0.5))
    return k


def _resample_pass(img: np.ndarray, coeffs: np.ndarray, axis: int
                   ) -> np.ndarray:
    """One pass along ``axis`` (1: width, 0: height) of uint8 [H, W, C]; the
    sums are integers below 2^53, exact in f64."""
    x = np.moveaxis(img.astype(np.float64), axis, -1)
    acc = x @ coeffs.T + float(1 << (_PRECISION_BITS - 1))
    out = np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255)
    return np.moveaxis(out.astype(np.uint8), -1, axis)


def _resize(img: np.ndarray, size: tuple[int, int], kernel,
            support: float) -> np.ndarray:
    w_out, h_out = size
    h, w = img.shape[:2]
    if (w_out, h_out) == (w, h):
        return img.copy()
    out = img
    if w_out != w:
        out = _resample_pass(out, _coeffs(w, w_out, kernel, support), 1)
    if h_out != h:
        out = _resample_pass(out, _coeffs(h, h_out, kernel, support), 0)
    return out


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [size[1], size[0], C], equal to PIL's
    ``Image.resize(size, Image.BILINEAR)`` (size is (width, height))."""
    return _resize(img, size, _bilinear, 1.0)


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [size[1], size[0], C], equal to PIL's
    ``Image.resize(size, Image.BICUBIC)``: support 2, clipped to uint8
    after each pass (the OpenCLIP preprocess's resize)."""
    return _resize(img, size, _bicubic, 2.0)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [size[1], size[0], C], picking the source pixels
    PIL's ``Image.resize(size, Image.NEAREST)`` picks (its 16.16 fixed-point
    affine walk from the first pixel's centre)."""
    w_out, h_out = size
    h, w = img.shape[:2]

    def src(n_in: int, n_out: int) -> np.ndarray:
        step = n_in / n_out
        a0 = math.floor(step * 65536.0 + 0.5)
        a2 = math.floor(step * 0.5 * 65536.0 + 0.5)
        return np.minimum((a2 + np.arange(n_out) * a0) >> 16, n_in - 1)

    return img[src(h, h_out)][:, src(w, w_out)]


# ------------------------------------------------------------------ banks
__DATASET__: dict[str, type] = {}


def register_dataset(name: str):
    def wrapper(cls):
        if __DATASET__.get(name) is not None:
            raise NameError(f"Name {name} is already registered!")
        __DATASET__[name] = cls
        return cls
    return wrapper


def get_dataset(name: str, root: str, **kwargs):
    if __DATASET__.get(name) is None:
        raise NameError(f"Dataset {name} is not defined.")
    return __DATASET__[name](root=root, **kwargs)


def _pil_rgb(path: str) -> np.ndarray:
    """An image PIL decodes as uint8 RGB [H, W, 3]. PIL is optional (the
    GPU machine has none): without it this raises ImportError."""
    try:
        pil_image = importlib.import_module("PIL.Image")
    except ImportError:
        raise ImportError(
            f"{path}: this port decodes PNG itself; other formats need PIL, "
            "which is not installed") from None
    with pil_image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_with_pil(path: str) -> np.ndarray:
    """A bank image PIL decodes (a JPEG) as uint8 RGB [H, W, 3]; without
    PIL this raises, saying how to run without it."""
    try:
        return _pil_rgb(path)
    except ImportError:
        raise ValueError(
            f"{path}: without PIL this port decodes PNG only. Convert the "
            "bank to PNG, or pass the projected bank as a .pt cache "
            "(repellency.params.proj_ref_path with cache_proj_ref: "
            "True).") from None


def read_rgb(path: str) -> np.ndarray:
    """Any image file as uint8 RGB [H, W, 3], as PIL's
    ``Image.open(path).convert("RGB")``: a PNG (by its magic bytes) through
    ``decode_png``, anything else (JPEG, ...) through PIL, which must then
    be installed (``ImportError`` without it)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        return decode_png(data, path)
    return _pil_rgb(path)


def get_transform(name: str = "", size: int = 512, **kwargs) -> Callable:
    """RGB uint8 [H, W, 3] -> resized to size², mapped to [-1, 1], CHW
    f32 (the reference's get_transform)."""

    def _tf(img: np.ndarray) -> np.ndarray:
        arr = resize_bilinear(img, (size, size)).astype(np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
        return np.transpose(arr, (2, 0, 1))

    return _tf


class _GlobImageDataset:
    max_images: Optional[int] = None
    exts = ("png", "jpg")

    def __init__(self, root: str, class_info: str = "",
                 transforms: Optional[Callable] = None, **_ignored):
        root_path = os.path.join(root, class_info)
        fpaths: list[str] = []
        for ext in self.exts:
            fpaths += glob(f"{root_path}/*.{ext}", recursive=True)
        self.fpaths = sorted(fpaths)
        if self.max_images is not None and len(self.fpaths) > self.max_images:
            # the reference's GPU-memory cap (data/dataloader.py:64-65)
            self.fpaths = self.fpaths[:self.max_images]
        if not self.fpaths:
            raise ValueError(f"File list is empty. Check the root "
                             f"{root_path!r}.")
        self.transforms = transforms or get_transform("")

    def __len__(self):
        return len(self.fpaths)

    def __getitem__(self, index: int) -> np.ndarray:
        path = self.fpaths[index]
        if path.lower().endswith(".png"):
            return self.transforms(read_png(path))
        return self.transforms(read_with_pil(path))


@register_dataset(name="nudity")
@register_dataset(name="inappropriate")
class NudityDataset(_GlobImageDataset):
    max_images = 3200


@register_dataset(name="artists")
class ArtistsDataset(_GlobImageDataset):
    max_images = None
    exts = ("png",)


def get_dataloader(dataset, batch_size: int, num_workers: int = 0,
                   train: bool = False):
    """Batches of ``dataset``'s images in order, each an [n, 3, H, W] f32
    array, the last one short (the reference's get_dataloader; the JAX
    package's, for chunked VAE encoding). ``num_workers`` and ``train`` are
    taken for the reference's signature and not read."""
    for start in range(0, len(dataset), batch_size):
        yield np.stack([dataset[i] for i in
                        range(start, min(start + batch_size, len(dataset)))])


def get_all_imgs(dataset, batch_size: int = 64) -> np.ndarray:
    """The whole bank as one [M, 3, H, W] f32 array (the reference's
    get_all_imgs: the bank is small enough by design)."""
    return np.stack([dataset[i] for i in range(len(dataset))], axis=0)


def load_image_bank(name: str, root: str, class_info: str = "",
                    size: int = 512) -> np.ndarray:
    """The registry, the transform and ``get_all_imgs`` in one call."""
    ds = get_dataset(name, root=root, class_info=class_info,
                     transforms=get_transform("", size=size))
    return get_all_imgs(ds)
