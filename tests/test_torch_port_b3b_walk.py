"""B3b's tilings (``csrc/conv3x3_up_bwd.cu``) walked in plain PyTorch on
the CPU, in f64, and held against ``conv3x3_up_bwd_ref`` and against
``jax.vjp`` of the JAX package's XLA form of the UNet upsample (a nearest
resize, then the SAME conv, as ``test_conv_up_backward_matches_jax_vjp``
builds it), at small ragged shapes: B = 2, patches past the image's
rows and columns, Ci and Co at 64 and 128.

The walk reads its tiles as the kernels' tensor maps do (boxes with
zeros outside the tensor):

- B3b-dx: dy viewed as [B, H, 2, W, 2 Co]; a k slice (tap (u, v), 64
  output channels) reads the box at row i + floor(u/2), parity u mod 2,
  column j + floor(v/2), channel (v mod 2) Co + c0 for an 8 x 16 patch,
  and W4[u, v] [128 or 160 ci x 64 co]; the slices of a tile split into
  ``split`` contiguous ranges (1..4), whose f32 tiles add in rank order;
- B3b-dw: per parity (py, px), a stage of 4 x 16 positions reads dy's
  box at parity (py, px), 128 output channels (two boxes of 64), and h's
  boxes at the four shifts (py + j - 1, px + k - 1); each block keeps the
  four (j, k) products; the cluster's fold adds, for each tap, the four
  parities' products in rank order, and db the parities' column sums
  (each the sum of two half-tiles of rows).

Mutants that must fail: a split dropped from the sum, a parity offset off
by one, and a row read from the neighbouring image (dy or h viewed with
the batch merged into the rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

TH, TW = t_conv.DX_PATCH
PH, PW = t_conv.DW_PATCH
CK, TMO, TNI = t_conv.DX_CK, t_conv.DW_TM, t_conv.DW_TN
# the f64 walk against the f64 plain backward (orders of f64 sums), and
# against JAX's f32 vjp (max |d| / max |jax|)
F64_RTOL, F32_RTOL = 1e-10, 2e-5
SHAPES = [(2, 5, 20, 64, 128), (2, 9, 7, 128, 64), (2, 3, 17, 128, 128)]


class Map:
    """A tensor map over ``t`` (dims outermost first, as torch lays them
    out): ``box(origin, size)`` is the box with zeros outside ``t``."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def box(self, origin, size) -> torch.Tensor:
        out = torch.zeros(size, dtype=self.t.dtype)
        src, dst = [], []
        for o, n, d in zip(origin, size, self.t.shape):
            lo, hi = max(o, 0), min(o + n, d)
            if lo >= hi:
                return out
            src.append(slice(lo, hi))
            dst.append(slice(lo - o, hi - o))
        out[tuple(dst)] = self.t[tuple(src)]
        return out


def dy_map(dy: torch.Tensor, merged: bool = False) -> Map:
    """dy [B, 2H, 2W, Co] viewed as [B, H, 2, W, 2 Co]; ``merged``: the
    batch folded into the rows (a mutant), [1, B H, 2, W, 2 Co]."""
    b, hh, ww, co = dy.shape
    v = dy.reshape(b, hh // 2, 2, ww // 2, 2 * co)
    return Map(v.reshape(1, b * hh // 2, 2, ww // 2, 2 * co) if merged else v)


def walk_dx(dy, w4, h_shape, tn, split, drop_split=False, row_shift=0,
            merged=False):
    """dh [B, H, W, Ci] as B3b-dx computes it: for each 8 x 16 patch and
    ``tn`` input channels, the k slices (tap, 64 output channels) in order,
    split into ``split`` ranges whose partials add in rank order.
    Mutants: ``drop_split`` leaves the last range out of the sum;
    ``row_shift`` moves every tap's row by that many half-res rows;
    ``merged`` reads dy with the batch merged into the rows."""
    bsz, h, w, ci = h_shape
    co = dy.shape[3]
    dmap, wmap = dy_map(dy, merged), Map(w4)
    nch = co // CK
    nsl = 16 * nch
    dh = torch.zeros(bsz, h, w, ci, dtype=dy.dtype)
    for b in range(bsz):
        for y0 in range(0, h, TH):
            for x0 in range(0, w, TW):
                for ci0 in range(0, ci, tn):
                    parts = []
                    for r in range(split):
                        acc = torch.zeros(TH * TW, tn, dtype=dy.dtype)
                        for sl in range(r * nsl // split,
                                        (r + 1) * nsl // split):
                            tap, c0 = sl // nch, (sl % nch) * CK
                            u2, v2 = tap // 4 + 1, tap % 4 + 1
                            i0 = y0 + (u2 >> 1) - 1 + row_shift
                            bb = b
                            if merged:
                                i0, bb = i0 + b * h, 0
                            a = dmap.box(
                                (bb, i0, u2 & 1, x0 + (v2 >> 1) - 1,
                                 (v2 & 1) * co + c0), (1, TH, 1, TW, CK))
                            bt = wmap.box((tap, ci0, c0), (1, tn, CK))
                            acc += a.reshape(TH * TW, CK) @ bt[0].T
                        parts.append(acc)
                    if drop_split:
                        parts = parts[:-1]
                    tile = parts[0].clone()
                    for p in parts[1:]:
                        tile += p
                    tile = tile.reshape(TH, TW, tn)
                    ny, nx, nc = (min(TH, h - y0), min(TW, w - x0),
                                  min(tn, ci - ci0))
                    dh[b, y0:y0 + ny, x0:x0 + nx, ci0:ci0 + nc] = \
                        tile[:ny, :nx, :nc]
    return dh


def _group_of(p: int, t: int) -> int:
    return (0 if t == 0 else 1) if p == 0 else (1 if t == 2 else 0)


def walk_dw(dy, h, drop_parity=None, shift=-1, merged=False):
    """(dW [Co, Ci, 3, 3], db [Co]) as B3b-dw computes them: per parity
    block (rank 2 py + px), 128 output x 64 input channels, stages of
    4 x 16 positions, four (j, k) products; then the fold of each tap over
    the ranks in order, and db over the ranks' half-tile column sums.
    Mutants: ``drop_parity`` leaves that rank out of the fold; ``shift``
    -1 is h's shift (py + j + shift); ``merged`` reads h with the batch
    merged into the rows."""
    bsz, hh, ww, ci = h.shape
    co = dy.shape[3]
    dmap = dy_map(dy)
    hmap = Map(h.reshape(1, bsz * hh, ww, ci) if merged else h)
    dw = torch.zeros(co, ci, 3, 3, dtype=dy.dtype)
    db = torch.zeros(co, dtype=dy.dtype)
    for co0 in range(0, co, TMO):
        for ci0 in range(0, ci, TNI):
            part, dbp = {}, {}
            for par in range(4):
                py, px = par >> 1, par & 1
                acc = [torch.zeros(TMO, TNI, dtype=dy.dtype)
                       for _ in range(4)]
                half = torch.zeros(2, TMO, dtype=dy.dtype)
                for b in range(bsz):
                    for y0 in range(0, hh, PH):
                        for x0 in range(0, ww, PW):
                            a = torch.cat([dmap.box(
                                (b, y0, py, x0, px * co + co0 + wgo),
                                (1, PH, 1, PW, CK)).reshape(PH * PW, CK)
                                for wgo in (0, CK)], dim=1)
                            for jk in range(4):
                                yy = y0 + py + (jk >> 1) + shift
                                xx = x0 + px + (jk & 1) - 1
                                org = ((0, yy + b * hh, xx, ci0) if merged
                                       else (b, yy, xx, ci0))
                                hb = hmap.box(org, (1, PH, PW, TNI)).reshape(
                                    PH * PW, TNI)
                                acc[jk] += a.T @ hb
                            half[0] += a[:PH * PW // 2].sum(0)
                            half[1] += a[PH * PW // 2:].sum(0)
                part[par] = acc
                dbp[par] = half[0] + half[1]
            ranks = [p for p in range(4) if p != drop_parity]
            nco, nci = min(TMO, co - co0), min(TNI, ci - ci0)
            for ky in range(3):
                for kx in range(3):
                    s = None
                    for par in ranks:
                        jk = (2 * _group_of(par >> 1, ky)
                              + _group_of(par & 1, kx))
                        s = part[par][jk] if s is None else s + part[par][jk]
                    dw[co0:co0 + nco, ci0:ci0 + nci, ky, kx] = s[:nco, :nci]
            if ci0 == 0:
                s = dbp[ranks[0]].clone()
                for par in ranks[1:]:
                    s += dbp[par]
                db[co0:co0 + nco] = s[:nco]
    return dw, db


def _inputs(bsz, h2, w2, ci, co, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(bsz, h2, w2, ci)
    w = rs.randn(co, ci, 3, 3) / (3 * ci ** 0.5)
    dy = rs.randn(bsz, 2 * h2, 2 * w2, co)
    return h, w, dy


def _w4(w: np.ndarray) -> torch.Tensor:
    """The folded weights in f64 ([16, Ci, Co]), as ``bwd_dx_weights``
    folds them before its bf16 rounding."""
    fold = torch.tensor(t_conv._FOLD, dtype=torch.float64)
    w4 = torch.einsum("uy,vx,oiyx->uvio", fold, fold, torch.from_numpy(w))
    return w4.reshape(16, *w4.shape[2:])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_vjp(h, w, dy):
    """dh, dW [Co, Ci, 3, 3], db of the JAX package's XLA upsample + conv,
    in f32."""
    def up_conv(h, w, b):
        bsz, h2, w2, ci = h.shape
        up = jax.image.resize(h, (bsz, 2 * h2, 2 * w2, ci), "nearest")
        return jax.lax.conv_general_dilated(
            up, w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    _, vjp = jax.vjp(up_conv, f32(h), f32(w.transpose(2, 3, 1, 0)),
                     f32(np.zeros(w.shape[0])))
    dh, dw, db = vjp(f32(dy))
    return (np.asarray(dh), np.asarray(dw).transpose(3, 2, 0, 1),
            np.asarray(db))


@pytest.fixture(scope="module")
def cases():
    """Per shape: inputs, the plain f64 backward and JAX's vjp."""
    out = {}
    for i, shape in enumerate(SHAPES):
        h, w, dy = _inputs(*shape, seed=10 + i)
        ref = t_conv.conv3x3_up_bwd_ref(*(torch.from_numpy(a)
                                          for a in (h, w, dy)))
        out[shape] = (h, w, dy, ref, _jax_vjp(h, w, dy))
    return out


@pytest.mark.parametrize("split", [1, 2, 3, 4])
@pytest.mark.parametrize("tn", t_conv.DX_TNS)
@pytest.mark.parametrize("shape", SHAPES)
def test_b3b_dx_walk_matches_plain_and_jax_vjp(cases, shape, tn, split):
    h, w, dy, ref, vjp = cases[shape]
    dh = walk_dx(torch.from_numpy(dy), _w4(w), h.shape, tn, split)
    assert _rel(dh, ref[0]) <= F64_RTOL
    assert _rel(dh, vjp[0]) <= F32_RTOL


@pytest.mark.parametrize("shape", SHAPES)
def test_b3b_dw_walk_matches_plain_and_jax_vjp(cases, shape):
    h, w, dy, ref, vjp = cases[shape]
    dw, db = walk_dw(torch.from_numpy(dy), torch.from_numpy(h))
    assert _rel(dw, ref[1]) <= F64_RTOL and _rel(db, ref[2]) <= F64_RTOL
    assert _rel(dw, vjp[1]) <= F32_RTOL and _rel(db, vjp[2]) <= F32_RTOL


@pytest.mark.parametrize("mutant", ["drop_split", "row_shift", "merged"])
def test_b3b_dx_walk_mutants_fail(cases, mutant):
    shape = SHAPES[0]
    h, w, dy, ref, _ = cases[shape]
    kw = {"drop_split": dict(drop_split=True), "row_shift":
          dict(row_shift=1), "merged": dict(merged=True)}[mutant]
    dh = walk_dx(torch.from_numpy(dy), _w4(w), h.shape, 128, 3, **kw)
    assert _rel(dh, ref[0]) > 0.05


@pytest.mark.parametrize("mutant", ["drop_parity", "shift", "merged"])
def test_b3b_dw_walk_mutants_fail(cases, mutant):
    shape = SHAPES[0]
    h, w, dy, ref, _ = cases[shape]
    kw = {"drop_parity": dict(drop_parity=3), "shift": dict(shift=0),
          "merged": dict(merged=True)}[mutant]
    dw, _ = walk_dw(torch.from_numpy(dy), torch.from_numpy(h), **kw)
    assert _rel(dw, ref[1]) > 0.05
