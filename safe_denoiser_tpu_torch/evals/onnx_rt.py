"""Minimal ONNX runtime: protobuf wire-format parser + numpy interpreter.

Copy of ``safe_denoiser_tpu/evals/onnx_rt.py`` (framework-free numpy; the
port imports nothing of the JAX package). The reference runs its NudeNet
classifier through onnxruntime, which neither machine has; this module
parses the raw ``.onnx`` file (ModelProto field numbers from
onnx/onnx.proto) and interprets the op set CNN-classifier exports use.
``Erf`` goes through ``torch.special.erf`` in f64 instead of scipy's.

Evaluation is not a hot path (the reference runs ORT on the CPU), so ops
are plain numpy; moving them onto torch is later work.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire decoding
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _packed_varints(buf: bytes) -> list[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag_to_signed(v: int, bits: int = 64) -> int:
    # ONNX int64 fields are plain (not zigzag); handle two's complement
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
               5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
               10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = 1
    raw = b""
    floats: list[float] = []
    ints32: list[int] = []
    ints64: list[int] = []
    name = ""
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1:
            if wtype == 0:
                dims.append(val)
            else:
                dims.extend(_packed_varints(val))
        elif fnum == 2:
            dtype = val
        elif fnum == 4:
            if wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fnum == 5:
            if wtype == 0:
                ints32.append(val)
            else:
                ints32.extend(_packed_varints(val))
        elif fnum == 7:
            if wtype == 0:
                ints64.append(_zigzag_to_signed(val))
            else:
                ints64.extend(_zigzag_to_signed(v) for v in _packed_varints(val))
        elif fnum == 8:
            name = val.decode("utf-8")
        elif fnum == 9:
            raw = val
    np_dtype = ONNX_DTYPES[dtype]
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np_dtype)
    elif ints64:
        arr = np.asarray(ints64, dtype=np_dtype)
    elif ints32:
        arr = np.asarray(ints32, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr


def parse_attribute(buf: bytes) -> tuple[str, Any]:
    name = ""
    a_f = a_i = a_s = a_t = None
    a_type = 0  # AttributeProto.type (field 20): 1=FLOAT 2=INT 3=STRING ...
    floats: list[float] = []
    ints: list[int] = []
    for fnum, wtype, val in iter_fields(buf):
        if fnum == 1:
            name = val.decode("utf-8")
        elif fnum == 20:
            a_type = val
        elif fnum == 2:
            a_f = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a_i = _zigzag_to_signed(val)
        elif fnum == 4:
            a_s = val
        elif fnum == 5:
            a_t = parse_tensor(val)[1]
        elif fnum == 7:
            if wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fnum == 8:
            if wtype == 0:
                ints.append(_zigzag_to_signed(val))
            else:
                ints.extend(_zigzag_to_signed(v) for v in _packed_varints(val))
    if a_t is not None:
        return name, a_t
    if a_s is not None:
        return name, a_s.decode("utf-8", errors="replace")
    if floats:
        return name, floats
    if ints:
        return name, ints
    if a_f is not None:
        return name, a_f
    if a_i is not None:
        return name, a_i
    # proto3 omits zero-valued scalars on the wire — reconstruct the typed
    # default from AttributeProto.type (e.g. Clip min=0.0, Pad value=0.0)
    if a_type == 1:      # FLOAT
        return name, 0.0
    if a_type == 2:      # INT
        return name, 0
    if a_type == 6:      # FLOATS
        return name, []
    if a_type == 7:      # INTS
        return name, []
    return name, None


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any]


@dataclass
class Graph:
    nodes: list[Node] = field(default_factory=list)
    initializers: dict[str, np.ndarray] = field(default_factory=dict)
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)


def _value_info_name(buf: bytes) -> str:
    for fnum, _, val in iter_fields(buf):
        if fnum == 1:
            return val.decode("utf-8")
    return ""


def parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for fnum, _, val in iter_fields(buf):
        if fnum == 1:  # node
            node = Node("", [], [], {})
            for nf, _, nv in iter_fields(val):
                if nf == 1:
                    node.inputs.append(nv.decode("utf-8"))
                elif nf == 2:
                    node.outputs.append(nv.decode("utf-8"))
                elif nf == 4:
                    node.op_type = nv.decode("utf-8")
                elif nf == 5:
                    # NodeProto.attribute = 5 (field 7 is `domain`). This was
                    # mis-read as 7 until a real torch.onnx-exported graph —
                    # whose attributes all silently vanished — exposed it;
                    # the hand-built fixtures had encoded the same wrong
                    # field number, so they round-tripped regardless
                    # (tests/test_onnx_torch_export.py guards this now).
                    k, v = parse_attribute(nv)
                    node.attrs[k] = v
            g.nodes.append(node)
        elif fnum == 5:  # initializer
            name, arr = parse_tensor(val)
            g.initializers[name] = arr
        elif fnum == 11:
            g.inputs.append(_value_info_name(val))
        elif fnum == 12:
            g.outputs.append(_value_info_name(val))
    return g


def parse_model(buf: bytes) -> Graph:
    for fnum, _, val in iter_fields(buf):
        if fnum == 7:  # ModelProto.graph
            return parse_graph(val)
    raise ValueError("no graph found in ONNX model")


# ---------------------------------------------------------------------------
# numpy interpreter
# ---------------------------------------------------------------------------


def _auto_pads(attrs, kernel, strides, in_shape):
    """Resolve pads from explicit attr or auto_pad (SAME_UPPER/LOWER)."""
    spatial = len(kernel)
    pads = attrs.get("pads")
    if pads is not None:
        return list(pads)
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("NOTSET", "VALID"):
        return [0] * (2 * spatial)
    begins, ends = [], []
    for i in range(spatial):
        out = -(-in_shape[i] // strides[i])
        total = max(0, (out - 1) * strides[i] + kernel[i] - in_shape[i])
        if auto == "SAME_UPPER":
            begins.append(total // 2)
            ends.append(total - total // 2)
        else:
            begins.append(total - total // 2)
            ends.append(total // 2)
    return begins + ends


def _conv(x, w, b, attrs):
    """NCHW conv via scipy-free im2col (grouped)."""
    strides = attrs.get("strides", [1, 1])
    dil = attrs.get("dilations", [1, 1])
    group = attrs.get("group", 1)
    kh, kw = w.shape[2], w.shape[3]
    pads = _auto_pads(attrs, [kh * dil[0] - dil[0] + 1, kw * dil[1] - dil[1] + 1],
                      strides, x.shape[2:])
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    n, c, h, wd = x.shape
    oc = w.shape[0]
    oh = (h - (kh - 1) * dil[0] - 1) // strides[0] + 1
    ow = (wd - (kw - 1) * dil[1] - 1) // strides[1] + 1
    cg = c // group
    ocg = oc // group
    out = np.empty((n, oc, oh, ow), dtype=np.float32)
    if group == c and cg == 1 and ocg == 1:
        # depthwise fast path (NudeNet's Xception separable convs are
        # Conv(group=C): the per-group python loop below would walk all C
        # channels; this vectorizes over them)
        out = np.zeros((n, oc, oh, ow), dtype=np.float32)
        for i in range(kh):
            for j in range(kw):
                patch = x[:, :, i * dil[0]:i * dil[0] + oh * strides[0]:strides[0],
                          j * dil[1]:j * dil[1] + ow * strides[1]:strides[1]]
                out += patch * w[:, 0, i, j][None, :, None, None]
        if b is not None:
            out += b.reshape(1, -1, 1, 1)
        return out
    # im2col per group
    for g in range(group):
        xg = x[:, g * cg:(g + 1) * cg]
        cols = np.empty((n, cg * kh * kw, oh * ow), dtype=np.float32)
        idx = 0
        for i in range(kh):
            for j in range(kw):
                patch = xg[:, :, i * dil[0]:i * dil[0] + oh * strides[0]:strides[0],
                           j * dil[1]:j * dil[1] + ow * strides[1]:strides[1]]
                cols[:, idx * cg:(idx + 1) * cg] = patch.reshape(n, cg, -1)
                idx += 1
        wg = w[g * ocg:(g + 1) * ocg]
        # reorder weight to (ocg, kh*kw*cg) matching cols layout (i,j,c)
        wg2 = wg.transpose(2, 3, 1, 0).reshape(-1, ocg)
        out[:, g * ocg:(g + 1) * ocg] = np.einsum(
            "nkp,ko->nop", cols, wg2).astype(np.float32).reshape(n, ocg, oh, ow)
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out


def _resize_coords(out_len: int, in_len: int, scale: float, ct: str):
    """Output index -> continuous input coordinate per ONNX Resize's
    coordinate_transformation_mode."""
    idx = np.arange(out_len, dtype=np.float64)
    if ct == "asymmetric":
        return idx / scale
    if ct == "align_corners":
        return idx * ((in_len - 1) / (out_len - 1)) if out_len > 1 \
            else np.zeros(out_len)
    if ct == "pytorch_half_pixel":
        return (idx + 0.5) / scale - 0.5 if out_len > 1 else np.zeros(out_len)
    if ct == "half_pixel":
        return (idx + 0.5) / scale - 0.5
    if ct == "tf_half_pixel_for_nn":
        # Spec: (x+0.5)/scale with NO trailing -0.5 (tf2onnx emits this for
        # TF nearest resizes with half_pixel_centers).
        return (idx + 0.5) / scale
    raise NotImplementedError(f"ONNX Resize coordinate mode {ct!r}")


def _resize_axis(x, axis: int, out_len: int, scale: float, mode: str,
                 ct: str, nearest_mode: str):
    in_len = x.shape[axis]
    coords = _resize_coords(out_len, in_len, scale, ct)
    if mode == "nearest":
        if nearest_mode == "round_prefer_floor":
            idx = np.ceil(coords - 0.5)
        elif nearest_mode == "round_prefer_ceil":
            idx = np.floor(coords + 0.5)
        elif nearest_mode == "floor":
            idx = np.floor(coords)
        elif nearest_mode == "ceil":
            idx = np.ceil(coords)
        else:
            raise NotImplementedError(f"ONNX Resize nearest_mode {nearest_mode!r}")
        return np.take(x, np.clip(idx, 0, in_len - 1).astype(np.int64),
                       axis=axis)
    if mode == "linear":
        lo = np.clip(np.floor(coords), 0, in_len - 1).astype(np.int64)
        hi = np.minimum(lo + 1, in_len - 1)
        w = np.clip(coords - lo, 0.0, 1.0)
        shape = [1] * x.ndim
        shape[axis] = out_len
        w = w.reshape(shape).astype(np.float32)
        return (np.take(x, lo, axis=axis) * (1.0 - w)
                + np.take(x, hi, axis=axis) * w)
    raise NotImplementedError(f"ONNX Resize mode {mode!r}")


def _pool(x, attrs, mode):
    kernel = attrs["kernel_shape"]
    strides = attrs.get("strides", [1, 1])
    pads = _auto_pads(attrs, kernel, strides, x.shape[2:])
    include_pad = bool(attrs.get("count_include_pad", 0))
    fill = -np.inf if mode == "max" else 0.0
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])),
               constant_values=fill)
    n, c, h, w = x.shape
    kh, kw = kernel
    oh = (h - kh) // strides[0] + 1
    ow = (w - kw) // strides[1] + 1
    if mode == "max":
        out = np.full((n, c, oh, ow), fill, dtype=np.float32)
        for i in range(kh):
            for j in range(kw):
                out = np.maximum(out, x[:, :, i:i + oh * strides[0]:strides[0],
                                        j:j + ow * strides[1]:strides[1]])
        return out
    ones = np.pad(np.ones((h - pads[0] - pads[2], w - pads[1] - pads[3]),
                          dtype=np.float32),
                  ((pads[0], pads[2]), (pads[1], pads[3])))
    acc = np.zeros((n, c, oh, ow), dtype=np.float32)
    cnt = np.zeros((oh, ow), dtype=np.float32)
    for i in range(kh):
        for j in range(kw):
            acc += x[:, :, i:i + oh * strides[0]:strides[0],
                     j:j + ow * strides[1]:strides[1]]
            cnt += ones[i:i + oh * strides[0]:strides[0],
                        j:j + ow * strides[1]:strides[1]]
    # ONNX default count_include_pad=0: divide by the valid-element count
    return acc / (np.float32(kh * kw) if include_pad else cnt[None, None])


def run_graph(graph: Graph, feeds: dict[str, np.ndarray],
              outputs: list[str] | None = None) -> list[np.ndarray]:
    env: dict[str, np.ndarray] = dict(graph.initializers)
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    outputs = outputs or graph.outputs

    for node in graph.nodes:
        i = [env[name] if name else None for name in node.inputs]
        op = node.op_type
        a = node.attrs
        if op == "Conv":
            r = _conv(i[0], i[1], i[2] if len(i) > 2 else None, a)
        elif op == "Relu":
            r = np.maximum(i[0], 0)
        elif op == "Sigmoid":
            r = 1 / (1 + np.exp(-i[0]))
        elif op == "Tanh":
            r = np.tanh(i[0])
        elif op == "Clip":
            lo = i[1] if len(i) > 1 and i[1] is not None else a.get("min", -np.inf)
            hi = i[2] if len(i) > 2 and i[2] is not None else a.get("max", np.inf)
            r = np.clip(i[0], lo, hi)
        elif op == "Add":
            r = i[0] + i[1]
        elif op == "Sub":
            r = i[0] - i[1]
        elif op == "Mul":
            r = i[0] * i[1]
        elif op == "Div":
            r = i[0] / i[1]
        elif op == "MatMul":
            r = i[0] @ i[1]
        elif op == "Gemm":
            x, w = i[0], i[1]
            if a.get("transA", 0):
                x = x.T
            if a.get("transB", 0):
                w = w.T
            r = a.get("alpha", 1.0) * (x @ w)
            if len(i) > 2 and i[2] is not None:
                r = r + a.get("beta", 1.0) * i[2]
        elif op == "BatchNormalization":
            x, scale, bias, mean, var = i[:5]
            eps = a.get("epsilon", 1e-5)
            shape = [1, -1] + [1] * (x.ndim - 2)
            r = (x - mean.reshape(shape)) / np.sqrt(var.reshape(shape) + eps)
            r = r * scale.reshape(shape) + bias.reshape(shape)
        elif op == "MaxPool":
            r = _pool(i[0], a, "max")
        elif op == "AveragePool":
            r = _pool(i[0], a, "avg")
        elif op == "GlobalAveragePool":
            r = i[0].mean(axis=tuple(range(2, i[0].ndim)), keepdims=True)
        elif op == "GlobalMaxPool":
            r = i[0].max(axis=tuple(range(2, i[0].ndim)), keepdims=True)
        elif op == "Softmax":
            ax = a.get("axis", -1)
            e = np.exp(i[0] - i[0].max(axis=ax, keepdims=True))
            r = e / e.sum(axis=ax, keepdims=True)
        elif op == "Concat":
            r = np.concatenate([x for x in i if x is not None], axis=a["axis"])
        elif op == "Reshape":
            shape = [int(s) for s in
                     (i[1].astype(np.int64) if len(i) > 1 else a["shape"])]
            # ONNX allowzero=0 default: a 0 entry copies the input dim
            if not a.get("allowzero", 0):
                shape = [i[0].shape[ax] if s == 0 else s
                         for ax, s in enumerate(shape)]
            r = i[0].reshape(shape)
        elif op == "Flatten":
            ax = a.get("axis", 1)
            r = i[0].reshape(int(np.prod(i[0].shape[:ax]) or 1), -1)
        elif op == "Transpose":
            r = np.transpose(i[0], a.get("perm"))
        elif op == "Squeeze":
            axes = a.get("axes") or (i[1].tolist() if len(i) > 1 else None)
            r = np.squeeze(i[0], axis=tuple(axes) if axes else None)
        elif op == "Unsqueeze":
            axes = a.get("axes") or i[1].tolist()
            r = i[0]
            for ax in sorted(axes):
                r = np.expand_dims(r, int(ax))
        elif op == "Pad":
            mode = a.get("mode", "constant")
            if isinstance(mode, bytes):
                mode = mode.decode()
            pads = a.get("pads") or i[1].tolist()
            half = len(pads) // 2
            pad_width = list(zip(pads[:half], pads[half:]))
            if mode == "constant":
                # opset-11+ passes the fill value as input 2; opset<11 as
                # the `value` attribute
                val = a.get("value", 0.0)
                if len(i) > 2 and i[2] is not None:
                    val = float(np.asarray(i[2]).reshape(()))
                r = np.pad(i[0], pad_width, constant_values=val)
            elif mode in ("reflect", "edge"):
                r = np.pad(i[0], pad_width, mode=mode)
            else:
                raise NotImplementedError(f"ONNX Pad mode {mode!r}")
        elif op in ("Identity", "Dropout", "Cast"):
            r = i[0].astype(ONNX_DTYPES.get(a.get("to"), i[0].dtype)) \
                if op == "Cast" else i[0]
        elif op == "Constant":
            # real exporters (torch.onnx, tf2onnx) emit weights/shape vectors
            # as Constant nodes, not only as graph initializers
            if "value" in a:
                r = a["value"]
            elif "value_float" in a:
                r = np.asarray(a["value_float"], dtype=np.float32)
            elif "value_floats" in a:
                r = np.asarray(a["value_floats"], dtype=np.float32)
            elif "value_int" in a:
                r = np.asarray(a["value_int"], dtype=np.int64)
            elif "value_ints" in a:
                r = np.asarray(a["value_ints"], dtype=np.int64)
            else:
                raise NotImplementedError(
                    f"ONNX Constant without a supported value form: {a}")
        elif op == "Shape":
            r = np.asarray(i[0].shape, dtype=np.int64)
        elif op == "Resize":
            # the keras-retinanet detector export (UpsampleLike) and torch's
            # F.interpolate both lower here; inputs are (X, roi, scales[,
            # sizes]) from opset 11 on
            x = i[0]
            sizes = i[3] if len(i) > 3 and i[3] is not None else None
            scales = i[2] if len(i) > 2 and i[2] is not None else None
            in_shape = np.asarray(x.shape, dtype=np.int64)
            if sizes is not None and np.asarray(sizes).size:
                out_shape = np.asarray(sizes, dtype=np.int64)
                sc = out_shape / in_shape
            elif scales is not None and np.asarray(scales).size:
                sc = np.asarray(scales, dtype=np.float64)
                out_shape = np.floor(in_shape * sc).astype(np.int64)
            else:
                raise NotImplementedError("ONNX Resize without scales/sizes")
            r = x
            for ax in range(x.ndim):
                if int(out_shape[ax]) != r.shape[ax]:
                    r = _resize_axis(
                        r, ax, int(out_shape[ax]), float(sc[ax]),
                        a.get("mode", "nearest"),
                        a.get("coordinate_transformation_mode", "half_pixel"),
                        a.get("nearest_mode", "round_prefer_floor"))
        elif op == "Upsample":
            # deprecated pre-Resize op (opset<=9): scales as attribute
            # (opset 7) or input 1 (opset 9); asymmetric coordinates with
            # floor rounding is what both opsets specified
            x = i[0]
            scales = a.get("scales")
            if scales is None:
                scales = np.asarray(i[1], dtype=np.float64).reshape(-1)
            sc = np.asarray(scales, dtype=np.float64)
            r = x
            for ax in range(x.ndim):
                out_len = int(np.floor(x.shape[ax] * sc[ax]))
                if out_len != r.shape[ax]:
                    r = _resize_axis(r, ax, out_len, float(sc[ax]),
                                     a.get("mode", "nearest"),
                                     "asymmetric", "floor")
        elif op == "Gather":
            r = np.take(i[0], i[1].astype(np.int64), axis=a.get("axis", 0))
        elif op in ("ReduceMean", "ReduceMax"):
            # opset<18 passes axes as an attribute; opset-18 moved them to
            # input 1 (optional — absent means reduce over all axes)
            axes = a.get("axes")
            if axes is None and len(i) > 1 and i[1] is not None:
                axes = [int(v) for v in np.asarray(i[1]).reshape(-1)]
            red = i[0].mean if op == "ReduceMean" else i[0].max
            r = red(axis=tuple(axes) if axes else None,
                    keepdims=bool(a.get("keepdims", 1)))
        elif op == "Exp":
            r = np.exp(i[0])
        elif op == "Log":
            r = np.log(i[0])
        elif op == "Sqrt":
            r = np.sqrt(i[0])
        elif op == "Pow":
            r = np.power(i[0], i[1])
        elif op == "Neg":
            r = -i[0]
        elif op == "Abs":
            r = np.abs(i[0])
        elif op == "Where":
            r = np.where(i[0], i[1], i[2])
        elif op in ("Greater", "Less", "Equal"):
            cmp = {"Greater": np.greater, "Less": np.less,
                   "Equal": np.equal}[op]
            r = cmp(i[0], i[1])
        elif op == "Slice":
            # opset-10+ input form (starts/ends[/axes[/steps]]); the
            # detector box-decode idiom slices coordinate columns
            if len(i) > 1 and i[1] is not None:
                starts = [int(v) for v in i[1]]
                ends = [int(v) for v in i[2]]
                axes = [int(v) for v in i[3]] if len(i) > 3 and \
                    i[3] is not None else list(range(len(starts)))
                steps = [int(v) for v in i[4]] if len(i) > 4 and \
                    i[4] is not None else [1] * len(starts)
            else:  # opset-1 attribute form
                starts = list(a["starts"])
                ends = list(a["ends"])
                axes = list(a.get("axes", range(len(starts))))
                steps = [1] * len(starts)
            sl = [slice(None)] * i[0].ndim
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                sl[ax] = slice(st, en, sp)
            r = i[0][tuple(sl)]
        elif op == "TopK":
            k = int(np.asarray(i[1]).reshape(())) if len(i) > 1 else a["k"]
            ax = a.get("axis", -1)
            largest = a.get("largest", 1)
            x = i[0] if largest else -i[0]
            idx = np.argsort(-x, axis=ax, kind="stable")
            idx = np.take(idx, range(k), axis=ax)
            vals = np.take_along_axis(i[0], idx, axis=ax)
            r = (vals, idx.astype(np.int64))  # multi-output
        elif op == "NonMaxSuppression":
            # boxes [N,S,4], scores [N,C,S] -> selected [M,3] (batch, class,
            # box). center_point_box=0 => [y1,x1,y2,x2] corners (the
            # keras-retinanet export convention)
            boxes, scores = i[0], i[1]
            max_out = int(np.asarray(i[2]).reshape(())) if len(i) > 2 and \
                i[2] is not None else 0
            iou_thr = float(np.asarray(i[3]).reshape(())) if len(i) > 3 and \
                i[3] is not None else 0.0
            score_thr = float(np.asarray(i[4]).reshape(())) if len(i) > 4 \
                and i[4] is not None else -np.inf
            center = a.get("center_point_box", 0)
            selected = []
            for n_i in range(boxes.shape[0]):
                bx = boxes[n_i].astype(np.float64)
                if center:
                    cx, cy, w_, h_ = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
                    bx = np.stack([cy - h_ / 2, cx - w_ / 2,
                                   cy + h_ / 2, cx + w_ / 2], axis=1)
                y1, x1, y2, x2 = (np.minimum(bx[:, 0], bx[:, 2]),
                                  np.minimum(bx[:, 1], bx[:, 3]),
                                  np.maximum(bx[:, 0], bx[:, 2]),
                                  np.maximum(bx[:, 1], bx[:, 3]))
                areas = (y2 - y1) * (x2 - x1)
                for c_i in range(scores.shape[1]):
                    sc = scores[n_i, c_i]
                    order = np.argsort(-sc, kind="stable")
                    order = order[sc[order] > score_thr]
                    keep = []
                    # ONNX spec: max_output_boxes_per_class=0 (the default)
                    # selects NO boxes — not unlimited
                    while order.size and len(keep) < max_out:
                        b0 = order[0]
                        keep.append(b0)
                        rest = order[1:]
                        yy1 = np.maximum(y1[b0], y1[rest])
                        xx1 = np.maximum(x1[b0], x1[rest])
                        yy2 = np.minimum(y2[b0], y2[rest])
                        xx2 = np.minimum(x2[b0], x2[rest])
                        inter = (np.clip(yy2 - yy1, 0, None)
                                 * np.clip(xx2 - xx1, 0, None))
                        iou = inter / (areas[b0] + areas[rest] - inter + 1e-12)
                        order = rest[iou <= iou_thr]
                    selected += [[n_i, c_i, int(b)] for b in keep]
            r = np.asarray(selected, dtype=np.int64).reshape(-1, 3)
        elif op == "GatherND":
            if a.get("batch_dims", 0):
                raise NotImplementedError(
                    "ONNX GatherND batch_dims >= 1 not supported")
            data, idx = i[0], i[1].astype(np.int64)
            r = data[tuple(np.moveaxis(idx, -1, 0))]
        elif op in ("Min", "Max", "Sum"):
            fn = {"Min": np.minimum, "Max": np.maximum, "Sum": np.add}[op]
            r = i[0]
            for x_i in i[1:]:
                r = fn(r, x_i)
        elif op in ("ReduceSum", "ReduceMin", "ReduceProd"):
            # same axes convention as ReduceMean above (attr, else input 1)
            axes = a.get("axes")
            if axes is None and len(i) > 1 and i[1] is not None:
                axes = [int(v) for v in np.asarray(i[1]).reshape(-1)]
            red = {"ReduceSum": i[0].sum, "ReduceMin": i[0].min,
                   "ReduceProd": i[0].prod}[op]
            r = red(axis=tuple(axes) if axes else None,
                    keepdims=bool(a.get("keepdims", 1)))
        elif op in ("ArgMax", "ArgMin"):
            if a.get("select_last_index", 0):
                raise NotImplementedError(
                    "ONNX ArgMax/ArgMin select_last_index not supported")
            fn = np.argmax if op == "ArgMax" else np.argmin
            ax = a.get("axis", 0)
            r = fn(i[0], axis=ax).astype(np.int64)
            if a.get("keepdims", 1):
                r = np.expand_dims(r, ax)
        elif op == "LeakyRelu":
            alpha = a.get("alpha", 0.01)
            r = np.where(i[0] >= 0, i[0], (alpha * i[0]).astype(i[0].dtype))
        elif op == "Elu":
            alpha = a.get("alpha", 1.0)
            r = np.where(i[0] >= 0, i[0],
                         (alpha * (np.exp(i[0]) - 1)).astype(i[0].dtype))
        elif op == "PRelu":
            r = np.where(i[0] >= 0, i[0], (i[1] * i[0]).astype(i[0].dtype))
        elif op == "HardSigmoid":
            alpha, beta = a.get("alpha", 0.2), a.get("beta", 0.5)
            r = np.clip(alpha * i[0] + beta, 0, 1).astype(i[0].dtype)
        elif op == "Softplus":
            r = np.logaddexp(i[0], 0).astype(i[0].dtype)
        elif op == "Erf":
            import torch
            r = torch.special.erf(torch.from_numpy(np.ascontiguousarray(
                i[0], np.float64))).numpy().astype(i[0].dtype)
        elif op in ("Floor", "Ceil", "Round", "Reciprocal"):
            fn = {"Floor": np.floor, "Ceil": np.ceil, "Round": np.round,
                  "Reciprocal": np.reciprocal}[op]   # Round: half-to-even
            r = fn(i[0])
        elif op == "Not":
            r = np.logical_not(i[0])
        elif op in ("And", "Or", "Xor"):
            fn = {"And": np.logical_and, "Or": np.logical_or,
                  "Xor": np.logical_xor}[op]
            r = fn(i[0], i[1])
        elif op == "Split":
            ax = a.get("axis", 0)
            split = a.get("split")
            if split is None and len(i) > 1 and i[1] is not None:
                split = [int(v) for v in np.asarray(i[1]).reshape(-1)]
            if split is None:
                n = a.get("num_outputs", len(node.outputs))
                dim = i[0].shape[ax]
                base = -(-dim // n)   # ceil-division chunks (ONNX spec)
                split = [base] * (dim // base) + \
                    ([dim % base] if dim % base else [])
                # The node declares exactly n outputs; when the ceil chunks
                # already cover dim (e.g. dim=6, n=4 -> [2,2,2]) the spec
                # still produces n tensors — trailing ones empty.
                split += [0] * (n - len(split))
            r = tuple(np.split(i[0], np.cumsum(split)[:-1], axis=ax))
        elif op == "Expand":
            shape = [int(v) for v in np.asarray(i[1]).reshape(-1)]
            r = np.broadcast_to(
                i[0], np.broadcast_shapes(i[0].shape, tuple(shape)))
        elif op == "Tile":
            r = np.tile(i[0], [int(v) for v in np.asarray(i[1]).reshape(-1)])
        elif op == "Range":
            start, limit, delta = (np.asarray(v).reshape(()) for v in i[:3])
            r = np.arange(start, limit, delta, dtype=np.asarray(i[0]).dtype)
        elif op == "ConstantOfShape":
            shape = tuple(int(v) for v in np.asarray(i[0]).reshape(-1))
            val = a.get("value")
            if val is None:
                r = np.zeros(shape, dtype=np.float32)
            else:
                val = np.asarray(val).reshape(-1)
                r = np.full(shape, val[0], dtype=val.dtype)
        elif op == "InstanceNormalization":
            eps = a.get("epsilon", 1e-5)
            x = i[0].astype(np.float32)
            sp = tuple(range(2, x.ndim))                  # NCHW spatial axes
            mean = x.mean(axis=sp, keepdims=True)
            var = x.var(axis=sp, keepdims=True)
            cshape = (1, -1) + (1,) * (x.ndim - 2)
            r = ((x - mean) / np.sqrt(var + eps) * i[1].reshape(cshape)
                 + i[2].reshape(cshape)).astype(i[0].dtype)
        else:
            raise NotImplementedError(f"ONNX op {op} not supported")
        outs = r if isinstance(r, tuple) else (r,) * len(node.outputs)
        for out_name, val in zip(node.outputs, outs):
            if out_name:
                env[out_name] = val

    return [env[name] for name in outputs]


class InferenceSession:
    """onnxruntime.InferenceSession-shaped wrapper over the interpreter."""

    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            self.graph = parse_model(f.read())

    def get_inputs(self):
        init = set(self.graph.initializers)
        names = [n for n in self.graph.inputs if n not in init]
        return [type("IO", (), {"name": n})() for n in names]

    def get_outputs(self):
        return [type("IO", (), {"name": n})() for n in self.graph.outputs]

    def run(self, output_names, feeds):
        return run_graph(self.graph, feeds,
                         output_names or self.graph.outputs)
