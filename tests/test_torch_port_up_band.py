"""The indexing of the upsample conv's Hopper kernel (``csrc/conv_hopper.cuh``
in its upsample form, behind ``csrc/conv3x3_up.cu``), emulated in numpy on
the CPU and held against the plain version ``conv3x3_up_ref``.

The emulation walks what the kernel walks: 8 x 16-pixel patches of the
half-res input (ragged ones at the right and bottom edges), 128-channel
output tiles (the upper half of the last one masked when Co % 128 == 64),
the four output parities, 64-channel chunks of Ci (the upper 32 zeros when
Ci % 64 == 32), each chunk's 10 x 18 halo band with origin (y0 - 1, x0 - 1)
and zeros outside the image, and per tap (j, k) the band rows at offset
(j + py, k + px) against the [128 x 64] slice of parity p's [Co, 4*Ci]
weights from ``kernel_weights``; each half-res pixel (y, x) is stored at
(2y + py, 2x + px).

The weights are multiples of 2^-8 small enough that every pre-summed parity
weight is exact in bf16, so the emulation differs from the plain version by
f32 summation order only, and an indexing slip (a tap off by a pixel, a
neighbouring image's row, a column that wraps, a lost parity shift) shows
far above the 2e-2 bound, also next to the border pixels of +-30.
"""

import numpy as np
import pytest
import torch

from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv

TH, TW, TN, CK = 8, 16, 128, 64     # the kernel's patch, channel tile, chunk


def _case(b, h2, w2, ci, co, seed, border=None):
    """bf16-exact h [B, H2, W2, Ci] (+-border on the outer rows and columns
    when given), dyadic weights [Co, Ci, 3, 3] and an f32 bias."""
    rs = np.random.RandomState(seed)
    h = torch.from_numpy(rs.randn(b, h2, w2, ci).astype(np.float32))
    h = h.bfloat16().float().numpy()
    if border is not None:
        sign = np.where(rs.rand(b, h2, w2, ci) < 0.5, -border, border)
        edge = np.zeros((h2, w2), bool)
        edge[[0, -1], :] = True
        edge[:, [0, -1]] = True
        h = np.where(edge[None, :, :, None], sign, h).astype(np.float32)
    w = rs.randint(-8, 9, size=(co, ci, 3, 3)).astype(np.float32) / 256.0
    bias = rs.randn(co).astype(np.float32)
    return h, w, bias


def _emulate(h, wt, bias, co, parity_shift=True):
    """The kernel's walk over h [B, H2, W2, Ci] with wt [4, Co, 4*Ci]."""
    b, h2, w2, ci = h.shape
    out = np.full((b, 2 * h2, 2 * w2, co), np.nan, np.float32)
    n_tiles = -(-co // TN)
    n_chunks = -(-ci // CK)
    for img in range(b):
        for y0 in range(0, h2, TH):
            for x0 in range(0, w2, TW):
                for nt in range(n_tiles):
                    n0 = nt * TN
                    for p in range(4):
                        py, px = p >> 1, p & 1
                        # the parity's slice, rows past Co zero (masked)
                        wp = np.zeros((TN, 4 * ci), np.float32)
                        rows = min(TN, co - n0)
                        wp[:rows] = wt[p, n0:n0 + rows]
                        acc = np.zeros((TH, TW, TN), np.float32)
                        for chunk in range(n_chunks):
                            c0 = chunk * CK
                            band = np.zeros((TH + 2, TW + 2, CK), np.float32)
                            for r in range(TH + 2):
                                yy = y0 - 1 + r
                                for s in range(TW + 2):
                                    xx = x0 - 1 + s
                                    if 0 <= yy < h2 and 0 <= xx < w2:
                                        piece = h[img, yy, xx, c0:c0 + CK]
                                        band[r, s, :piece.size] = piece
                            for tap in range(4):
                                j, k = tap >> 1, tap & 1
                                dy = j + (py if parity_shift else 0)
                                dx = k + (px if parity_shift else 0)
                                a = band[dy:dy + TH, dx:dx + TW]
                                ws = np.zeros((TN, CK), np.float32)
                                cols = wp[:, tap * ci + c0:tap * ci + c0 + CK]
                                ws[:, :cols.shape[1]] = cols
                                acc += a @ ws.T
                        for r in range(TH):
                            for s in range(TW):
                                y, x = y0 + r, x0 + s
                                if y < h2 and x < w2:
                                    out[img, 2 * y + py, 2 * x + px,
                                        n0:n0 + rows] = (acc[r, s, :rows]
                                                         + bias[n0:n0 + rows])
    return out


def _plain(h, w, bias):
    return t_conv.conv3x3_up_ref(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(bias)).numpy()


@pytest.mark.parametrize("b,h2,w2,ci,co,border", [
    (2, 5, 7, 32, 64, None),       # less than a patch, half a chunk and tile
    (1, 9, 17, 96, 192, None),     # ragged patches; Ci, Co % 128 == 32, 64
    (3, 3, 8, 64, 128, 30.0),      # H2 = 3, W2 = 8, +-30 on every border
    (1, 16, 32, 128, 128, None)])  # whole patches, two chunks
def test_band_walk_reproduces_the_upsample_conv(b, h2, w2, ci, co, border):
    h, w, bias = _case(b, h2, w2, ci, co, seed=ci + co, border=border)
    wt = t_conv.kernel_weights(torch.from_numpy(w)).float().numpy()
    got = _emulate(h, wt, bias, co)
    assert not np.isnan(got).any()          # every output pixel written
    np.testing.assert_allclose(got, _plain(h, w, bias), atol=2e-2)


def test_band_walk_without_the_parity_shift_fails():
    """The mutant the GPU tests are run against (every parity's taps at band
    offset (j, k)) is far outside the bound: the emulation tells the two
    apart."""
    h, w, bias = _case(3, 3, 8, 64, 128, seed=1, border=30.0)
    wt = t_conv.kernel_weights(torch.from_numpy(w)).float().numpy()
    got = _emulate(h, wt, bias, 128, parity_shift=False)
    assert np.abs(got - _plain(h, w, bias)).max() > 1.0


def test_dyadic_weights_are_exact_in_the_kernel_layout():
    """The premise of the bound above: the pre-summed bf16 parity weights
    equal their f32 sums."""
    _, w, _ = _case(1, 2, 2, 96, 64, seed=3)
    wt = t_conv.kernel_weights(torch.from_numpy(w))
    exact = t_conv.w_eff_up(torch.from_numpy(w).permute(2, 3, 1, 0))
    exact = exact.reshape(4, 4, 96, 64).permute(0, 3, 1, 2).reshape(4, 64,
                                                                     384)
    assert torch.equal(wt.float(), exact)
