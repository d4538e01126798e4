"""B1b's decomposition (``csrc/attention_bwd.cu``) walked in plain PyTorch
on the CPU, in f32, and held against ``attention_bwd_ref`` and against
``jax.vjp`` of the JAX package's einsum attention
(``models/layers.py::dot_product_attention``) at tiny shapes: S in {77,
200} (tails past every tile), D in {40, 64, 80} (the training path's head
dims: 40 and 80 padded to 48 and 128 columns).

The walk follows the kernel's tiles: the head dim zero-padded to the D
class, rows past S zero (as the tensor maps zero-fill them); the
logsumexp L taken from a walk of B1's online softmax (exp2 domain, keys
in tiles of 128, 64 for D > 64, keys past S masked); Delta =
rowsum(dO * O); dK and dV by blocks of 128 keys (two warpgroups of 64),
query tiles of 64 (32 for D > 64) with L and Delta zero past S; dQ by
blocks of 128 queries, key tiles of 128 (64 for D > 64) in order, keys
past S masked. A
walk without Delta fails; a walk without the dQ pass's key mask turns
rows of very negative logits into NaN, which the mask prevents.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.models import layers as j_layers
from safe_denoiser_tpu_torch.ops import attention as t_attn

ROWS = 128      # keys (dK/dV) or queries (dQ) a block owns
WG_ROWS = 64    # of them, a consumer warpgroup's
# walk against the plain backward and against jax.vjp in f32, max |d| /
# max |ref| per output: the same f32 arithmetic in other orders
WALK_RTOL = 2e-5
LSE_ATOL = 2e-5  # the walk's logsumexp against the plain one (log2 units)


def d_class(d: int) -> int:
    """The head-dim columns of the kernel's tiles (the forward's D
    classes)."""
    return 48 if d <= 48 else 64 if d <= 64 else 80 if d <= 80 else 128


def tiles(d: int) -> tuple[int, int, int]:
    """(width of dK/dV/dQ, dK/dV's query tile, the key tile of the forward
    and of dQ)."""
    nv = -(-d_class(d) // 64) * 64
    return nv, (64 if nv == 64 else 32), (128 if nv == 64 else 64)


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[S, D] zero-padded to [rows, cols]: what a tensor map reads."""
    out = torch.zeros(rows, cols, dtype=x.dtype)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def walk_lse(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """B1's online softmax over key tiles for one head, q and k [S, D]:
    per row m + log2(l) of the exp2-domain logits c q.k."""
    s, d = q.shape
    _, _, bk = tiles(d)
    c = scale * math.log2(math.e)
    n = -(-s // bk) * bk
    kp = _pad(k, n, d_class(d))
    qp = _pad(q, s, d_class(d))
    m = torch.full((s,), -math.inf)
    l = torch.zeros(s)
    for k0 in range(0, n, bk):
        z = (qp @ kp[k0:k0 + bk].T) * c
        z[:, max(0, s - k0):] = -math.inf            # keys at or past S
        mn = torch.maximum(m, z.max(dim=1).values)
        l = l * torch.exp2(m - mn) + torch.exp2(z - mn[:, None]).sum(1)
        m = mn
    return m + torch.log2(l)


def walk_bwd(q, k, v, o, do, scale: float, lse, delta_term: bool = True,
             key_mask: bool = True):
    """dq, dk, dv of one head ([S, D] each) as the kernel's three passes
    compute them, lse [S] the forward's."""
    s, d = q.shape
    nv, bq, bk = tiles(d)
    dp_cols = d_class(d)
    c = scale * math.log2(math.e)
    n = -(-s // ROWS) * ROWS
    # the maps' view: zero rows past S, zero columns past D
    qp, kp, vp, dop = (_pad(t, n, nv) for t in (q, k, v, do))
    qp[:, dp_cols:] = kp[:, dp_cols:] = vp[:, dp_cols:] = 0
    lp = torch.zeros(n)
    lp[:s] = lse
    # pass 1: Delta, column order
    delta = torch.zeros(n)
    if delta_term:
        delta[:s] = (do * o).sum(1)
    # pass 2: dK, dV by key blocks
    dk, dv = torch.zeros(n, nv), torch.zeros(n, nv)
    for k0 in range(0, n, ROWS):
        for w in range(ROWS // WG_ROWS):
            rows = slice(k0 + w * WG_ROWS, k0 + (w + 1) * WG_ROWS)
            acc_k, acc_v = torch.zeros(WG_ROWS, nv), torch.zeros(WG_ROWS, nv)
            for q0 in range(0, -(-s // bq) * bq, bq):
                qs = slice(q0, q0 + bq)
                st = kp[rows] @ qp[qs].T                   # S^T
                dpt = vp[rows] @ dop[qs].T                 # dP^T
                pt = torch.exp2(st * c - lp[qs][None, :])  # P^T
                dst = pt * (dpt - delta[qs][None, :])      # dS^T
                acc_v += pt @ dop[qs]
                acc_k += dst @ qp[qs]
            dk[rows], dv[rows] = acc_k * scale, acc_v
    # pass 3: dQ by query blocks, key tiles in order
    dq = torch.zeros(n, nv)
    for r0 in range(0, n, WG_ROWS):
        rows = slice(r0, r0 + WG_ROWS)
        acc = torch.zeros(WG_ROWS, nv)
        for k0 in range(0, -(-s // bk) * bk, bk):
            ks = slice(k0, k0 + bk)
            p = torch.exp2((qp[rows] @ kp[ks].T) * c - lp[rows][:, None])
            if key_mask:
                p[:, max(0, s - k0):] = 0
            ds = p * ((dop[rows] @ vp[ks].T) - delta[rows][:, None])
            acc += ds @ kp[ks]
        dq[rows] = acc * scale
    return tuple(t[:s, :d] for t in (dq, dk, dv))


def _inputs(s, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(1, s, 2, d).astype(np.float32) * 0.8 for _ in range(4)]


def _heads(x: torch.Tensor):
    """[1, S, H, D] -> the heads' [S, D] slices."""
    return [x[0, :, i] for i in range(x.shape[2])]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _walk(q, k, v, do, scale, **kw):
    """The walk over every head of [1, S, H, D] tensors: (dq, dk, dv, lse
    [1, H, S], out)."""
    out = t_attn.attention_ref(q, k, v, scale)
    grads, lses = [], []
    for hq, hk, hv, ho, hdo in zip(*(_heads(t) for t in (q, k, v, out, do))):
        lse = walk_lse(hq, hk, scale)
        lses.append(lse)
        grads.append(walk_bwd(hq, hk, hv, ho, hdo, scale, lse, **kw))
    dq, dk, dv = (torch.stack([g[i] for g in grads], dim=1)[None]
                  for i in range(3))
    return dq, dk, dv, torch.stack(lses)[None], out


@pytest.mark.parametrize("d", [40, 64, 80])
@pytest.mark.parametrize("s", [77, 200])
def test_b1b_walk_matches_plain_and_jax_vjp(s, d):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(s, d, s + d))
    scale = d ** -0.5
    dq, dk, dv, lse, out = _walk(q, k, v, do, scale)
    want = t_attn.attention_bwd_ref(q, k, v, out, do, scale)
    for g_, w_ in zip((dq, dk, dv), want):
        assert _rel(g_, w_) <= WALK_RTOL
    assert (lse - t_attn.attention_lse_ref(q, k, scale)).abs().max() \
        <= LSE_ATOL
    _, vjp = jax.vjp(j_layers.dot_product_attention,
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g_, w_ in zip((dq, dk, dv), vjp(jnp.asarray(do.numpy()))):
        assert _rel(g_, w_) <= WALK_RTOL


@pytest.mark.parametrize("s,d", [(77, 40), (200, 80)])
def test_plain_logsumexp_matches_jax(s, d):
    """``attention_lse_ref`` (exp2 domain) against ``jax.nn.logsumexp`` of
    the JAX package's logits (q * scale) . k, taken to log2."""
    q, k = (a for a in _inputs(s, d, 7)[:2])
    scale = d ** -0.5
    logits = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) * scale,
                        jnp.asarray(k))
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1)) / math.log(2.0)
    got = t_attn.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   scale)
    assert got.shape == (1, 2, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LSE_ATOL)


def test_b1b_walk_without_delta_fails():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(77, 40, 1))
    scale = 40 ** -0.5
    dq, dk, _, _, out = _walk(q, k, v, do, scale, delta_term=False)
    want = t_attn.attention_bwd_ref(q, k, v, out, do, scale)
    assert _rel(dq, want[0]) > 0.1 and _rel(dk, want[1]) > 0.1


def test_b1b_dq_key_mask_keeps_very_negative_rows_finite():
    """Logits near -158 (L near -228 in log2): an unmasked zero key past S
    gets P = 2^228 = inf in f32 and its zero K row turns dQ into NaN; the
    masked walk stays finite and equal to the plain backward."""
    s, d = 77, 40
    rs = np.random.RandomState(3)
    q = torch.from_numpy(5 + 0.1 * rs.randn(1, s, 2, d).astype(np.float32))
    k = torch.from_numpy(-5 + 0.1 * rs.randn(1, s, 2, d).astype(np.float32))
    v, do = (torch.from_numpy(rs.randn(1, s, 2, d).astype(np.float32))
             for _ in range(2))
    scale = d ** -0.5
    dq, dk, dv, _, out = _walk(q, k, v, do, scale)
    want = t_attn.attention_bwd_ref(q, k, v, out, do, scale)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    # f32 logits near -158 are rounded to ~1e-5 absolute in other orders by
    # the walk (c * q.k) and the plain version ((q * scale) . k): ~1e-3 of P
    for g_, w_ in zip((dq, dk, dv), want):
        assert _rel(g_, w_) <= 2e-3
    dq_bad = _walk(q, k, v, do, scale, key_mask=False)[0]
    assert torch.isnan(dq_bad).any()
