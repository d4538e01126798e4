"""The indexing of the interleaved upsample conv's Hopper kernel (the
interleave form of ``csrc/conv_hopper.cuh``, ``up4_kernel``, behind
``csrc/conv3x3_up_interleave.cu``), emulated in numpy on the CPU and held
against the plain version ``conv3x3_up_ref``.

The emulation walks what the kernel walks: 4 x 16-pixel patches of the
half-res input (ragged ones at the right and bottom edges) and 64-channel
output tiles, each block taking all four output parities; 64-channel chunks
of Ci (the upper 32 zeros when Ci % 64 == 32), each chunk's 6 x 18 halo
band with origin (y0 - 1, x0 - 1) and zeros outside the image, copied once
for all 16 (parity, tap) products; per chunk 8 ring stages (px, j, k), each
holding the [64 x 64] weight slices of parities (0, px) and (1, px) one
above the other, from which warpgroup w (py = w) reads its half; warp i of
it reads band rows at offset (i + j + w, k + px) into the accumulator of
px. The epilogue stages the 8 x 32 full-res tile, half-res pixel (y, x) of
parity (py, px) at (2y + py, 2x + px), and stores the pixels inside the
image.

Exact-bf16 dyadic weights as in ``test_torch_port_up_band.py``, so the
emulation differs from the plain version by f32 summation order only and
an indexing slip shows far above the 2e-2 bound, also next to +-30
borders.
"""

import numpy as np
import pytest
import torch

from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv
from tests.test_torch_port_up_band import _case, _plain

PH, PW, TN, CK = 4, 16, 64, 64     # the kernel's patch, channel tile, chunk


def _emulate(h, wt, bias, co, parity_shift=True):
    """The kernel's walk over h [B, H2, W2, Ci] with wt [4, Co, 4*Ci]."""
    b, h2, w2, ci = h.shape
    out = np.full((b, 2 * h2, 2 * w2, co), np.nan, np.float32)
    n_chunks = -(-ci // CK)
    for img in range(b):
        for y0 in range(0, h2, PH):
            for x0 in range(0, w2, PW):
                for n0 in range(0, co, TN):
                    # acc[py][px]: warpgroup py's two accumulators
                    acc = np.zeros((2, 2, PH, PW, TN), np.float32)
                    for chunk in range(n_chunks):
                        c0 = chunk * CK
                        band = np.zeros((PH + 2, PW + 2, CK), np.float32)
                        for r in range(PH + 2):
                            yy = y0 - 1 + r
                            for s in range(PW + 2):
                                xx = x0 - 1 + s
                                if 0 <= yy < h2 and 0 <= xx < w2:
                                    piece = h[img, yy, xx, c0:c0 + CK]
                                    band[r, s, :piece.size] = piece
                        for stage in range(8):
                            px, tap = stage >> 2, stage & 3
                            j, k = tap >> 1, tap & 1
                            # the ring stage: parity (0, px) rows over
                            # parity (1, px) rows, zeros past Ci
                            ring = np.zeros((2 * TN, CK), np.float32)
                            for py in range(2):
                                cols = wt[2 * py + px, n0:n0 + TN,
                                          tap * ci + c0:tap * ci + c0 + CK]
                                ring[py * TN:py * TN + TN,
                                     :cols.shape[1]] = cols
                            for wg in range(2):
                                dy = j + (wg if parity_shift else 0)
                                dx = k + (px if parity_shift else 0)
                                for i in range(PH):      # warp i, patch row
                                    a = band[i + dy, dx:dx + PW]
                                    acc[wg, px, i] += (
                                        a @ ring[wg * TN:wg * TN + TN].T)
                    stg = np.zeros((2 * PH, 2 * PW, TN), np.float32)
                    for py in range(2):
                        for px in range(2):
                            stg[py::2, px::2] = acc[py, px]
                    for m in range(2 * PH * 2 * PW):
                        yy = 2 * y0 + m // (2 * PW)
                        xx = 2 * x0 + m % (2 * PW)
                        if yy < 2 * h2 and xx < 2 * w2:
                            out[img, yy, xx, n0:n0 + TN] = (
                                stg[m // (2 * PW), m % (2 * PW)]
                                + bias[n0:n0 + TN])
    return out


@pytest.mark.parametrize("b,h2,w2,ci,co,border", [
    (2, 3, 7, 32, 64, None),       # less than a patch, half a chunk
    (1, 9, 17, 96, 192, None),     # ragged patches, Ci % 64 == 32, 3 tiles
    (3, 4, 16, 64, 128, 30.0),     # whole patches, +-30 on every border
    (1, 6, 20, 128, 64, 30.0)])    # two chunks, ragged, +-30 borders
def test_band_walk_reproduces_the_upsample_conv(b, h2, w2, ci, co, border):
    h, w, bias = _case(b, h2, w2, ci, co, seed=ci + co + 1, border=border)
    wt = t_conv.kernel_weights(torch.from_numpy(w)).float().numpy()
    got = _emulate(h, wt, bias, co)
    assert not np.isnan(got).any()          # every output pixel written
    np.testing.assert_allclose(got, _plain(h, w, bias), atol=2e-2)


def test_band_walk_without_the_parity_shift_fails():
    """The mutant the GPU tests are run against (every parity's taps at band
    offset (i + j, k)) is far outside the bound: the emulation tells the two
    apart."""
    h, w, bias = _case(3, 4, 16, 64, 128, seed=2, border=30.0)
    wt = t_conv.kernel_weights(torch.from_numpy(w)).float().numpy()
    got = _emulate(h, wt, bias, 128, parity_shift=False)
    assert np.abs(got - _plain(h, w, bias)).max() > 1.0
