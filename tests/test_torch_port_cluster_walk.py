"""The reduction order of the two cluster-reduction kernels, emulated in
numpy on the CPU: the fused GroupNorm (``csrc/group_norm.cu``) and the RBF
repellency score (``csrc/rbf.cu``), each on the plan its wrapper computes
(``group_norm.gn_plan``, ``repellency_kernels.rbf_plan``).

GroupNorm: per batch row and tile of whole groups, the cluster's blocks
split the rows; in a block, a thread sums one channel over one of the
block's row chunks (rows q, q + chunks, ...) in row order, the block adds
the chunks in order, and a group's channels in runs of 8 in order, then
the runs in order, and every block adds the cluster's blocks' partials in
rank order, all of it in f64 (x^2 by FMA: exact products of f32 values);
then a = scale / sqrt(var + eps) and b = bias - mean * a per channel,
each rounded once to f32, and
y = x*a + b with the product and the sum rounded apart, SiLU in f32 or at
bf16.

RBF score: pass 1 splits D over the cluster's blocks and a block's slice
over its 8 warps, for all of the block's bank rows; lane l takes vectors
l, l + 32, ... of its warp's part (FMA sums of the Gram terms, |r|^2 and
|x|^2), the warp adds its lanes by an xor butterfly, the block its warps
in order, the cluster its blocks in rank order; pass 2 splits M over the
cluster's blocks, each summing w r over its rows in order, and adds the
blocks' partials in rank order before normalizing. An f32 FMA is emulated
as the f64 product plus the f64 addend, rounded once to f32.

Both walks are held against the plain versions and against the JAX
package's Pallas kernels in interpret mode (uneven row tails, group width
10, narrow vectors, M not a multiple of its split); a mutant that drops one
block's partial from the rank-order sum must fail the same comparison.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from safe_denoiser_tpu.ops import group_norm as j_gn
from safe_denoiser_tpu.ops import repellency_kernels as j_rep
from safe_denoiser_tpu_torch.ops import group_norm as t_gn
from safe_denoiser_tpu_torch.ops import repellency_kernels as t_rep

F32 = np.float32


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, F32)).bfloat16() \
        .float().numpy()


def _sigmoid(v):
    return (F32(1) / (F32(1) + np.exp(-v))).astype(F32)


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


# ------------------------------------------------------------------- B6
def gn_walk(x, scale, bias, groups, eps, act, esize, fast, drop_rank=None):
    """The fused GroupNorm kernel's arithmetic on x [B, S, C] (f32 values;
    bf16 ones for esize 2) under ``gn_plan``; f32 output before rounding
    to x's dtype. ``drop_rank`` leaves that block out of every cluster sum
    (a mutant)."""
    b, s, c = x.shape
    plan = t_gn.gn_plan(b, s, c, groups, esize)
    cg, ct, chunks, rows = c // groups, plan.ct, plan.chunks, plan.rows
    n = float(s * cg)
    y = np.empty((b, s, c), F32)
    for bi in range(b):
        for t in range(plan.tiles):
            xs = x[bi, :, t * ct:(t + 1) * ct]
            gp1, gp2 = [], []
            for rank in range(plan.cl):
                sl = xs[rank * rows:min(s, (rank + 1) * rows)]
                p1 = np.zeros((chunks, ct))       # f64 throughout
                p2 = np.zeros((chunks, ct))
                # chunk q holds rows q, q + chunks, ...
                for r in range(0, len(sl), chunks):
                    v = sl[r:r + chunks].astype(np.float64)
                    p1[:len(v)] = p1[:len(v)] + v
                    p2[:len(v)] = p2[:len(v)] + v * v
                c1, c2 = np.zeros(ct), np.zeros(ct)
                for q in range(chunks):
                    c1, c2 = c1 + p1[q], c2 + p2[q]
                g1, g2 = np.zeros(ct // cg), np.zeros(ct // cg)
                for u in range(0, cg, 8):     # runs of 8 channels in order
                    r1, r2 = np.zeros_like(g1), np.zeros_like(g2)
                    for j in range(u, min(cg, u + 8)):
                        r1, r2 = r1 + c1[j::cg], r2 + c2[j::cg]
                    g1, g2 = g1 + r1, g2 + r2
                gp1.append(g1)
                gp2.append(g2)
            t1, t2 = np.zeros(ct // cg), np.zeros(ct // cg)
            for rank in range(plan.cl):
                if rank != drop_rank:
                    t1, t2 = t1 + gp1[rank], t2 + gp2[rank]
            mean = t1 / n
            var = t2 / n - mean * mean
            inv_c, mean_c = np.repeat(1 / np.sqrt(var + F32(eps)), cg), \
                np.repeat(mean, cg)
            a = (scale[t * ct:(t + 1) * ct] * inv_c).astype(F32)
            bb = (bias[t * ct:(t + 1) * ct] - mean_c * a).astype(F32)
            v = xs * a + bb
            if act == "silu":
                if fast:
                    v = _bf16(v)
                    v = v * _bf16(_sigmoid(v))
                else:
                    v = v * _sigmoid(v)
            y[bi, :, t * ct:(t + 1) * ct] = v
    return y


def _gn_case(b, s, c, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, c) * 2 + (5.0 if dtype == "bf16" else 0.5))
    x = x.astype(F32)
    if dtype == "bf16":
        x = _bf16(x)
    scale = (1 + 0.5 * rng.randn(c)).astype(F32)
    bias = (0.5 * rng.randn(c)).astype(F32)
    return x, scale, bias


def _gn_errors(monkeypatch, b, s, c, groups, mode, drop_rank=None):
    """(max|walk - plain|, max|walk - TPU kernel|, tolerance): f32 within
    the GPU test's 5e-5 + 1e-5 |plain|, reported as the excess over
    1e-5 |plain|; bf16 within one bf16 ulp of max|y|."""
    monkeypatch.setenv("SDT_FAST_SILU", "0" if mode == "bf16-slow" else "1")
    j_gn.group_norm_pallas.clear_cache()      # the switch is read at trace
    dtype = "f32" if mode == "f32" else "bf16"
    x, scale, bias = _gn_case(b, s, c, dtype)
    fast = mode == "bf16"
    got = gn_walk(x, scale, bias, groups, 1e-5, "silu",
                  4 if dtype == "f32" else 2, fast, drop_rank)
    tx = torch.from_numpy(x) if dtype == "f32" else \
        torch.from_numpy(x).bfloat16()
    plain = t_gn.group_norm_fused_ref(tx, torch.from_numpy(scale),
                                      torch.from_numpy(bias), groups, 1e-5,
                                      "silu").float().numpy()
    jx = jnp.asarray(x) if dtype == "f32" else \
        jnp.asarray(x).astype(jnp.bfloat16)
    tpu = np.asarray(j_gn.group_norm_pallas(
        jx, jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5, "silu",
        interpret=True), F32)
    if dtype == "f32":
        return ((np.abs(got - plain) - 1e-5 * np.abs(plain)).max(),
                (np.abs(got - tpu) - 1e-5 * np.abs(tpu)).max(), 5e-5)
    got = _bf16(got)
    return (np.abs(got - plain).max(), np.abs(got - tpu).max(),
            _bf16_ulp(np.abs(plain).max()))


@pytest.mark.parametrize("b,s,c,groups", [
    (2, 301, 160, 16),      # group width 10, rows 151 a block, tail 150
    (2, 301, 60, 6),        # 20-byte bf16 tiles: 4-byte vectors
    (1, 77, 2560, 2),       # 1280-channel tiles: one chunk a channel
    (3, 77, 36, 3)])        # group width 12
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16-slow"])
def test_group_norm_walk_matches_plain_and_tpu_kernel(monkeypatch, b, s, c,
                                                      groups, mode):
    plan = t_gn.gn_plan(b, s, c, groups, 4 if mode == "f32" else 2)
    assert plan.cl > 1 and s % plan.rows, plan     # an uneven row tail
    e_plain, e_tpu, tol = _gn_errors(monkeypatch, b, s, c, groups, mode)
    assert e_plain <= tol and e_tpu <= tol, (e_plain, e_tpu, tol)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_group_norm_walk_without_a_peer_fails(monkeypatch, mode):
    """The mutant: one block's group partials left out of the cluster's
    rank-order sum."""
    e_plain, e_tpu, tol = _gn_errors(monkeypatch, 2, 301, 160, 16, mode,
                                     drop_rank=1)
    assert e_plain > 10 * tol and e_tpu > 10 * tol, (e_plain, e_tpu, tol)


@pytest.mark.parametrize("b,s,c,groups,esize", [
    (8, 4096, 320, 32, 2), (8, 1024, 1280, 32, 2), (8, 64, 2560, 32, 2),
    (8, 4096, 320, 32, 4), (8, 1024, 640, 32, 2), (8, 256, 1280, 32, 2),
    (2, 4096, 320, 32, 2), (1, 1, 96, 8, 4), (2, 77, 33, 3, 2),
    (4, 65536, 128, 32, 4), (1, 9, 8192, 2, 2)])
def test_group_norm_plan_is_one_the_kernel_takes(b, s, c, groups, esize):
    """The checks ``sdt_group_norm_fused`` makes and the shared memory it
    computes (``smem_bytes``); whole-group tiles, clusters of at most 2
    blocks, no empty block, the one-read form where the slice fits."""
    p = t_gn.gn_plan(b, s, c, groups, esize)
    cg = c // groups
    assert p.ct * p.tiles == c and p.ct % cg == 0 and p.ct <= 4096
    assert 1 <= p.cl <= 2 and p.rows * p.cl >= s > p.rows * (p.cl - 1)
    assert p.vb in (2, 4, 8, 16) and p.vb >= esize and p.pass_rows >= 1
    assert (p.ct * esize) % p.vb == 0 and (c * esize) % p.vb == 0
    assert p.chunks == (1024 // p.ct if p.ct < 1024 else 1)
    k = p.ct // cg
    parts = 16 * p.chunks * p.ct + 16 * (p.ct + k * -(-cg // 8) + k)
    staged = p.rows if p.resident else 2 * p.pass_rows
    assert p.smem == -(-staged * p.ct * esize // 16) * 16 + parts <= 232448


def test_group_norm_plans_at_the_main_path_shapes():
    """One read of x in 128 blocks at the UNet's three phase-3 bf16
    shapes: clusters of 2 with row segments of 80 and 320 bytes, and one
    block a tile at S = 64 (320-byte segments), and at the f32 one in
    256."""
    for (s, c), ct, cl in (((4096, 320), 40, 2), ((1024, 1280), 160, 2),
                           ((64, 2560), 160, 1)):
        p = t_gn.gn_plan(8, s, c, 32, 2)
        assert p.resident and p.vb == 16 and (p.ct, p.cl) == (ct, cl)
        assert 8 * p.tiles * p.cl == 128
    p = t_gn.gn_plan(8, 4096, 320, 32, 4)
    assert p.resident and 8 * p.tiles * p.cl == 256


# ------------------------------------------------------------------- B2
def _butterfly(v):
    """An xor butterfly over axis 1 (32 lanes): lane 0's sum."""
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, idx ^ off]
    return v[:, 0]


def rbf_walk(x, refs, sigma, eps, normalize, vec, drop_slice=None):
    """Both passes of the RBF kernel on x [N, D], refs [M, D] (f32) under
    ``rbf_plan``. ``drop_slice`` leaves that D-slice's Gram partial out of
    pass 1's rank-order sum (a mutant)."""
    n, d = x.shape
    m = refs.shape[0]
    p = t_rep.rbf_plan(n, m, d, vec)
    two_s2 = F32(2.0 * sigma ** 2)
    gs = np.zeros((m, n), F32)
    xs2 = np.zeros(n, F32)
    rs = np.zeros(m, F32)
    for rank in range(p.cl1):
        d0 = rank * p.ds
        nvec = max(0, min(p.ds, d - d0)) // vec
        per = -(-nvec // 8)
        gb, xb, rb = (np.zeros((m, n), F32), np.zeros(n, F32),
                      np.zeros(m, F32))
        for wcol in range(8):
            v0, v1 = wcol * per, min(nvec, (wcol + 1) * per)
            g = np.zeros((m, 32, n), F32)
            xx = np.zeros((1, 32, n), F32)
            rr = np.zeros((m, 32), F32)
            for k in range(v0, v1, 32):
                lanes = np.arange(k, min(k + 32, v1)) - k
                for e in range(vec):
                    cols = d0 + (k + lanes) * vec + e
                    rv = refs[:, cols]                      # [M, lanes]
                    xv = x[:, cols].T[None]                 # [1, lanes, N]
                    rr[:, lanes] = _fma(rv, rv, rr[:, lanes])
                    g[:, lanes] = _fma(xv, rv[:, :, None], g[:, lanes])
                    xx[:, lanes] = _fma(xv, xv, xx[:, lanes])
            gb, rb = gb + _butterfly(g), rb + _butterfly(rr)
            xb = xb + _butterfly(xx)[0]
        if rank != drop_slice:
            gs = gs + gb
        xs2, rs = xs2 + xb, rs + rb
    d2 = np.maximum((xs2[None, :] + rs[:, None]) - F32(2) * gs, F32(0))
    w = np.exp(-np.sqrt(d2) / two_s2).astype(F32).T          # [N, M]
    num = np.zeros((n, d), F32)
    beta = np.zeros(n, F32)
    for rank in range(p.cl2):
        acc = np.zeros((n, d), F32)
        bpart = np.zeros(n, F32)
        for mm in range(rank * p.ms, min(m, (rank + 1) * p.ms)):
            acc = _fma(w[:, mm:mm + 1], refs[mm][None], acc)
            bpart = bpart + w[:, mm]
        num, beta = num + acc, beta + bpart
    if not normalize:
        return num, beta
    beta = beta + F32(eps)
    return num / beta[:, None], beta


def _rbf_case(n, m, d, seed=0):
    """Bank rows with |r|^2 ~ 4096 and x near the first rows, as the GPU
    test draws them, so the weights span ~1e-2..1."""
    rng = np.random.RandomState(seed)
    refs = (rng.randn(m, d) * (4096 / d) ** 0.5).astype(F32)
    x = (refs[np.arange(n) % m]
         + 0.1 * (4096 / d) ** 0.5 * rng.randn(n, d)).astype(F32)
    return x, refs


def _rbf_errors(x, refs, normalize, vec, drop_slice=None, tpu=True):
    """For the plain version and the TPU kernel: the largest of num's
    |d| - 1e-4 |want| and beta's |d| / |want|, each within 1e-4 under the
    GPU test's bounds."""
    num, beta = rbf_walk(x, refs, 3.15, 1e-8, normalize, vec, drop_slice)
    wn, wb = t_rep.rbf_negative_score_ref(torch.from_numpy(x),
                                          torch.from_numpy(refs), 3.15,
                                          1e-8, normalize)
    refs_out = [(wn.numpy(), wb.numpy())]
    if tpu:
        jn, jb = j_rep.rbf_negative_score_pallas(
            jnp.asarray(x), jnp.asarray(refs), 3.15, 1e-8, normalize,
            interpret=True)
        refs_out.append((np.asarray(jn), np.asarray(jb)))
    return [max((np.abs(num - a) - 1e-4 * np.abs(a)).max(),
                (np.abs(beta - b) / np.abs(b)).max()) for a, b in refs_out]


@pytest.mark.parametrize("n,m,d,vec", [
    (3, 37, 2048, 4),       # 2 D-slices, M in 16 runs of 3 (3 empty)
    (16, 300, 1024, 4),     # N = 16, one D-slice, M 300 = 15 x 19 + 15
    (2, 515, 4096, 4),      # 4 D-slices, 8 rows a block, runs of 33
    (3, 37, 2048, 1)])      # scalar loads
@pytest.mark.parametrize("normalize", [True, False])
def test_rbf_walk_matches_plain_and_tpu_kernel(n, m, d, vec, normalize):
    p = t_rep.rbf_plan(n, m, d, vec)
    assert p.cl2 > 1 and m % p.ms, p                  # M's split is uneven
    x, refs = _rbf_case(n, m, d)
    errs = _rbf_errors(x, refs, normalize, vec)
    assert max(errs) <= 1e-4, errs


@pytest.mark.parametrize("n,m,d", [(4, 515, 16384), (1, 16, 262144)])
def test_rbf_walk_at_the_main_path_shapes(n, m, d):
    """SD-v1's [4, 16384] against 515 rows (4 D-slices, 8 rows a block, M
    in 16 runs) and SD3's [1, 262144] against 16 (16 D-slices, one row a
    block, M in 2 runs), against the plain version."""
    p = t_rep.rbf_plan(n, m, d, 4)
    assert (p.mr, p.cl1, p.cl2) == ((8, 4, 16) if n == 4 else (1, 16, 2))
    x, refs = _rbf_case(n, m, d)
    errs = _rbf_errors(x, refs, True, 4, tpu=False)
    assert max(errs) <= 1e-4, errs


def test_rbf_walk_without_a_d_slice_fails():
    """The mutant: one D-slice's Gram partial left out of pass 1's sum."""
    x, refs = _rbf_case(3, 37, 2048)
    errs = _rbf_errors(x, refs, True, 4, drop_slice=1)
    assert min(errs) > 1e-2, errs


@pytest.mark.parametrize("n,m,d,vec", [
    (4, 515, 16384, 4), (1, 16, 262144, 4), (1, 37, 1000, 4),
    (16, 600, 4096, 4), (3, 1, 128, 4), (16, 300, 999, 1),
    (16, 100000, 256, 4), (5, 7, 5, 1)])
def test_rbf_plan_is_one_the_kernel_takes(n, m, d, vec):
    """The checks ``sdt_rbf_score_f32`` makes; clusters of a power of two
    blocks."""
    p = t_rep.rbf_plan(n, m, d, vec)
    assert 1 <= p.mr <= (8 if n <= 8 else 4)
    assert -(-m // p.mr) <= 65535
    for cl in (p.cl1, p.cl2):
        assert cl in (1, 2, 4, 8, 16)
    assert p.ds % 4 == 0 and p.ds * p.cl1 >= d and p.ms * p.cl2 >= m
