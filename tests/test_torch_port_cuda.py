"""The port's kernels on the GPU against their plain versions, at shapes
and layouts the main path of chip_smoke.py does not reach: sequence tails,
other head dims, strided and unaligned rows, the f32 attention path, the
int8-QK^T kernel's rounding ties and zero rows, the layout kernels (nt,
bshd, the head repacks) and their switches, small and odd banks, odd
image sizes, channel counts that are not a tile's, the fused GroupNorm at
group widths that are not powers of two, in its one-read and re-read
forms and with narrow vectors, the cluster kernels' plans and their
determinism, the interleaved upsample conv against the planar one, the
MMDiT's one-pass norm and residual kernel (adaln) at SD3-medium's rows,
other widths and a slot's slice, under a CUDA graph, and in the MMDiT;
and the host modules around the kernels on the GPU against the CPU: the
repellency processors (the sparse force, LSH's bucket gather), the Q16
gate's vision tower, and the evaluators' towers (FID Inception, OpenCLIP,
the in-loop CLIPScore) in f32 with PyTorch's TF32 switches on; and the
CUDA graphs of the sampling loop and the decode (``pipeline/graph.py``)
against the eager body on the same buffers, bit for bit, with the launch
counters per replay and outputs that survive the next replay.

Every test is marked ``cuda`` and skips where no GPU is visible. On a GPU
machine (which need not have JAX; ``--noconftest`` skips the suite's JAX
set-up):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from safe_denoiser_tpu_torch import ops
from safe_denoiser_tpu_torch.ops import (
    adaln, attention, conv3x3, group_norm, qk_rope, repellency_kernels)

pytestmark = pytest.mark.cuda

ATTN_BF16_TOL = attention.BF16_ATOL


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # the plain versions' f32 products and convolutions in full f32
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("layout", ["contiguous", "packed_qkv", "padded_rows"])
@pytest.mark.parametrize("b,s,h,d", [
    (1, 600, 2, 40), (2, 512, 1, 64), (1, 1000, 2, 80), (1, 512, 2, 128),
    (1, 520, 1, 160), (1, 512, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_matches_plain(dev, b, s, h, d, layout, dtype):
    """bf16: against the plain version on the same values upcast to f32,
    within ATTN_BF16_TOL. f32: f32 round-off. packed_qkv reads q/k/v as
    views of one [B,S,3,H,D] projection; padded_rows as views of
    [B,S,H,D+4] rows, whose strides defeat the 16-byte loads."""
    g = _gen(0)
    if layout == "packed_qkv":
        qkv = torch.randn(b, s, 3, h, d, device=dev, generator=g).to(dtype)
        q, k, v = qkv.unbind(2)
    elif layout == "padded_rows":
        q, k, v = (torch.randn(b, s, h, d + 4, device=dev,
                               generator=g).to(dtype)[..., :d]
                   for _ in range(3))
    else:
        q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g).to(dtype)
                   for _ in range(3))
    scale = d ** -0.5
    got = attention.self_attention(q, k, v, scale)
    want = attention.attention_ref(q.float(), k.float(), v.float(), scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL,
                                   rtol=0)
    else:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,d", [(600, 40), (1000, 80), (520, 160)])
def test_attention_kernel_masks_the_key_tail(dev, s, d):
    """Keys past S get no weight. Every real logit is made negative (q >= 0,
    k <= 0, logits ~ N(-4..-6, 0.8)), so a zero-filled key past S, whose
    logit would be 0, would outweigh dozens of real keys and shrink the
    output by half or more."""
    g = _gen(4)
    shape = (1, s, 2, d)
    q = torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    k = -torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    v = torch.randn(shape, device=dev, generator=g).bfloat16()
    got = attention.self_attention(q, k, v, d ** -0.5)
    want = attention.attention_ref(q.float(), k.float(), v.float(),
                                   d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    """B1's wrapper raises; the dispatch in front of it casts to the
    compute dtype first (f32 unless v is bf16), as the JAX package, so
    f16 or mixed inputs reach the kernel in f32."""
    ops.reset_launch_counts()
    x = torch.randn(1, 512, 2, 40, device=dev)
    with pytest.raises(ValueError):
        attention._self_attention_cuda(x.half(), x.half(), x.half(), 0.1)
    with pytest.raises(ValueError):
        attention._self_attention_cuda(x, x.bfloat16(), x, 0.1)
    with pytest.raises(ValueError):
        attention.self_attention(x, x.transpose(1, 2).contiguous()
                                 .transpose(1, 2), x, 0.1)
    with pytest.raises(ValueError):
        attention.self_attention(x, x, x.cpu(), 0.1)
    assert ops.launch_counts()["attention"] == 0
    got = attention.self_attention(x.half(), x.half(), x.half(), 0.1)
    assert got.dtype == torch.float16 and ops.launch_counts()["attention"] == 1
    torch.testing.assert_close(
        got.float(), attention.attention_ref(*(x.half().float(),) * 3, 0.1),
        atol=1e-3, rtol=0)


def test_attention_kernel_at_the_sd3_joint_shape(dev):
    """B1 at SD3's joint attention: [2, 4429, 24, 64] (4429 = 69 * 64 + 13
    keys, so a partial tail tile)."""
    g = _gen(10)
    q, k, v = (torch.randn(2, 4429, 24, 64, device=dev, generator=g)
               .bfloat16() for _ in range(3))
    got = attention.self_attention(q, k, v, 0.125)
    want = attention.attention_ref(q.float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("b,s,h,d", [(1, 4096, 2, 40), (1, 4429, 2, 64),
                                     (2, 1024, 4, 80)])
def test_attention_kernel_at_full_main_path_s(dev, b, s, h, d):
    """B1 at the main path's head dims and full sequence lengths (SD-v1's
    4096 at D = 40 and 1024 at 80, SD3's joint 4429 at 64), fewer heads."""
    g = _gen(11)
    q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g).bfloat16()
               for _ in range(3))
    got = attention.self_attention(q, k, v, d ** -0.5)
    want = attention.attention_ref(q.float(), k.float(), v.float(),
                                   d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


def test_attention_copies_only_views_its_tensor_maps_cannot_take(dev):
    """B1 reads q/k/v through TMA tensor maps: the main path's views (three
    projections, SD3's concatenation, one packed projection) go in as
    they are; rows padded to D+4 are copied first, one count a call."""
    g = _gen(14)
    b, s, h, d = 2, 600, 2, 40
    qkv = torch.randn(b, s, 3, h, d, device=dev, generator=g).bfloat16()
    padded = [torch.randn(b, s, h, d + 4, device=dev, generator=g)
              .bfloat16()[..., :d] for _ in range(3)]
    before = attention.staging_copies
    for q, k, v in (qkv.unbind(2), torch.cat([qkv, qkv], 1).unbind(2)):
        attention.self_attention(q, k, v, d ** -0.5)
    assert attention.staging_copies == before
    got = attention.self_attention(*padded, d ** -0.5)
    assert attention.staging_copies == before + 1
    want = attention.attention_ref(*(t.float() for t in padded), d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("logits", ["normal", "negative"])
@pytest.mark.parametrize("s", [600, 4429])
@pytest.mark.parametrize("d", [40, 64, 80])
def test_attention_kernel_partial_query_block_and_key_tail(dev, s, d, logits):
    """S = 600 (4 x 128 + 88) and 4429 (34 x 128 + 77) leave a partial
    128-row query block and a partial 64-key tile. With "negative" every
    real logit is below zero (q >= 0, k <= 0), so a zero-filled key past S
    that kept its logit 0 would outweigh the real keys."""
    g = _gen(12)
    shape = (1, s, 2, d)
    q, k, v = (torch.randn(shape, device=dev, generator=g) for _ in range(3))
    if logits == "negative":
        q, k = q.abs(), -k.abs()
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attention.self_attention(q, k, v, d ** -0.5)
    want = attention.attention_ref(q.float(), k.float(), v.float(),
                                   d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == shape and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


# ------------------------------------------------------------ attention_i8
def _i8(q, k, v, scale):
    return attention._self_attention_i8_cuda(q, k, v, scale)


def _i8_want(q, k, v, scale):
    return attention.attention_i8_ref(q.float(), k.float(), v.float(), scale)


@pytest.mark.parametrize("s", [600, 1000, 4429])
@pytest.mark.parametrize("d", [40, 64, 80])
def test_attention_i8_kernel_matches_plain(dev, s, d):
    """B8 against its plain version (the same int8 values and exact
    integer logits, f32 softmax and P V) on the same bf16 values, within
    ATTN_BF16_TOL: D = 40 / 80 pad to 64 / 96 in the int8 contraction;
    S = 600, 1000, 4429 end in partial key tiles."""
    g = _gen(11)
    q, k, v = (torch.randn(1, s, 2, d, device=dev, generator=g).bfloat16()
               for _ in range(3))
    got = _i8(q, k, v, d ** -0.5)
    want = _i8_want(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (1, s, 2, d)
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("s,d", [(600, 40), (1000, 80), (4429, 64)])
def test_attention_i8_kernel_masks_the_key_tail(dev, s, d):
    """Every real logit negative (q >= 0, k <= 0), so a zero-filled key
    past S, whose quantized logit is 0, would outweigh the real keys."""
    g = _gen(12)
    shape = (1, s, 2, d)
    q = torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    k = -torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    v = torch.randn(shape, device=dev, generator=g).bfloat16()
    torch.testing.assert_close(_i8(q, k, v, d ** -0.5).float(),
                               _i8_want(q, k, v, d ** -0.5),
                               atol=ATTN_BF16_TOL, rtol=0)


def test_attention_i8_kernel_zero_rows(dev):
    """All-zero query rows and key tokens (amax 0, the 1e-20 guard)
    quantize to zero: finite outputs, equal to the plain version's."""
    g = _gen(13)
    q, k, v = (torch.randn(1, 700, 2, 64, device=dev, generator=g)
               .bfloat16() for _ in range(3))
    q[:, 5:70] = 0
    k[:, 100:400] = 0
    got = _i8(q, k, v, 0.125)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), _i8_want(q, k, v, 0.125),
                               atol=ATTN_BF16_TOL, rtol=0)


def test_attention_i8_kernel_rounds_ties_to_even(dev):
    """Scaled values that are exact .5 ties: each query row's amax is 127
    (scale 1), its other entries +-0.5, which round half to even to 0; the
    keys are +-127 with a zero first entry. So every integer logit is 0
    and the output is the mean of v, 0 here (v = +1 on the keys whose
    entries are +127, -1 on the others). Rounding half away from zero
    would make the ties +-1 and put all weight on one half of the keys
    (|output| ~ 1)."""
    s, d = 640, 64
    q = torch.full((1, s, 2, d), 0.5, device=dev)
    q[..., 1::2] = -0.5
    q[..., 0] = 127.0
    k = torch.full((1, s, 2, d), 127.0, device=dev)
    k[:, 1::2, :, 1:] = -127.0
    k[..., 0] = 0.0
    v = torch.ones((1, s, 2, d), device=dev)
    v[:, 1::2] = -1.0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want = _i8_want(q, k, v, 0.125)
    assert want.abs().max().item() == 0.0
    torch.testing.assert_close(_i8(q, k, v, 0.125).float(), want,
                               atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("s", [129, 575, 1087])
@pytest.mark.parametrize("d", [40, 80])
def test_attention_i8_kernel_partial_tiles_across_heads(dev, s, d):
    """S not a multiple of the 128-query block or of the key tile (128 keys
    at D = 40, 64 at D = 80), with 2 x 3 heads in one head-major int8
    scratch: the tensor maps' bounds must zero-fill the rows past S rather
    than read the next head's, and every real logit is negative (q >= 0,
    k <= 0), so a weighed zero row would outweigh the real keys."""
    g = _gen(15)
    shape = (2, s, 3, d)
    q = torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    k = -torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    v = torch.randn(shape, device=dev, generator=g).bfloat16()
    got = _i8(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == shape and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), _i8_want(q, k, v, d ** -0.5),
                               atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("layout", ["packed_qkv", "padded_rows"])
def test_attention_i8_kernel_strided_views(dev, layout):
    """q/k/v as views of one [B,S,3,H,D] projection, or of [B,S,H,D+4]
    rows (strides that defeat the 16-byte loads)."""
    g = _gen(14)
    b, s, h, d = 2, 600, 3, 64
    if layout == "packed_qkv":
        q, k, v = torch.randn(b, s, 3, h, d, device=dev,
                              generator=g).bfloat16().unbind(2)
    else:
        q, k, v = (torch.randn(b, s, h, d + 4, device=dev,
                               generator=g).bfloat16()[..., :d]
                   for _ in range(3))
    torch.testing.assert_close(_i8(q, k, v, d ** -0.5).float(),
                               _i8_want(q, k, v, d ** -0.5),
                               atol=ATTN_BF16_TOL, rtol=0)


def test_attention_i8_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ops.reset_launch_counts()
    x = torch.randn(1, 512, 2, 64, device=dev).bfloat16()
    wide = torch.randn(1, 520, 1, 264, device=dev).bfloat16()
    for q, k, v in ((x.float(), x.float(), x.float()),     # f32
                    (wide, wide, wide),                      # D > 256
                    (x, x, x.cpu()),                         # two devices
                    (x, x.half(), x)):
        with pytest.raises(ValueError):
            _i8(q, k, v, 0.1)
    assert ops.launch_counts()["attention_i8"] == 0


def test_int8_switch_routes_bf16_only(dev, monkeypatch):
    """SDT_INT8_ATTN=1: bf16 self-attention launches B8; f32 keeps B1."""
    monkeypatch.setenv("SDT_INT8_ATTN", "1")
    ops.reset_launch_counts()
    x = torch.randn(1, 512, 2, 64, device=dev)
    attention.self_attention(x.bfloat16(), x.bfloat16(), x.bfloat16(), 0.1)
    attention.self_attention(x, x, x, 0.1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["attention_i8"], counts["attention"]) == (1, 1)


# ------------------------------------------------- attention layout kernels
def _close(got, want, dtype):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL,
                                   rtol=0)
    else:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bh,s,d,valid", [
    (4, 512, 40, None), (2, 1024, 64, 600), (3, 1024, 80, 1000),
    (2, 520, 128, None), (1, 512, 160, 300), (1, 512, 256, 512),
    (2, 512, 20, 450)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_nt_kernel_matches_plain(dev, bh, s, d, valid, dtype):
    """B9 on head-major [BH, S, D] against its plain version on the same
    values: keys past valid_kv are the zero rows of a padded sequence (and
    masked), S=520 ends in a partial key tile, D=20 is copied with its head
    dim zero-padded to 24 (bf16) before the tensor maps."""
    g = _gen(20)
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g).to(dtype)
               for _ in range(3))
    if valid is not None:
        k[:, valid:] = 0
        v[:, valid:] = 0
    got = attention.attention_nt(q, k, v, d ** -0.5, valid)
    want = attention.attention_nt_ref(q.float(), k.float(), v.float(),
                                      d ** -0.5, valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, s, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("s,d", [(600, 40), (1000, 80), (4429, 64)])
def test_attention_nt_kernel_masks_the_key_tail(dev, monkeypatch, s, d):
    """Through the nt dispatch (S padded to the 512 grid, valid_kv = S):
    every real logit negative (q >= 0, k <= 0), so a padded zero key,
    whose logit is 0, would outweigh the real keys if it were weighed."""
    monkeypatch.setenv("SDT_FLASH2_LAYOUT", "nt")
    monkeypatch.delenv("SDT_ATTN_REPACK", raising=False)
    g = _gen(21)
    shape = (1, s, 2, d)
    q = torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    k = -torch.randn(shape, device=dev, generator=g).abs().bfloat16()
    v = torch.randn(shape, device=dev, generator=g).bfloat16()
    ops.reset_launch_counts()
    got = attention.self_attention(q, k, v, d ** -0.5)
    want = attention.attention_ref(q.float(), k.float(), v.float(),
                                   d ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["attention_nt"] == 1
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("b,s,h,d", [
    (1, 512, 2, 40), (2, 1024, 8, 80), (1, 512, 8, 40), (1, 512, 3, 64),
    (1, 1024, 6, 48), (1, 512, 5, 24), (1, 512, 2, 128), (1, 512, 2, 160),
    (1, 512, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_bshd_kernel_matches_plain(dev, b, s, h, d, dtype):
    """B10 on natural [B, S, H, D] against its plain version: 8, 6 and 5
    heads interleaved in each row, the wide heads, D=24 and D=48 (the
    tensor maps zero-fill the columns up to the 64-column box)."""
    g = _gen(22)
    q, k, v = (torch.randn(b, s, h, d, device=dev, generator=g).to(dtype)
               for _ in range(3))
    got = attention.attention_bshd(q, k, v, d ** -0.5)
    want = attention.attention_ref(q.float(), k.float(), v.float(),
                                   d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("valid", [1, 77, 127, 128, 129, 383])
@pytest.mark.parametrize("s", [512, 600, 1000])
@pytest.mark.parametrize("d", [64, 80])
def test_attention_nt_kernel_key_counts_around_the_tiles(dev, s, valid, d):
    """B9's key count against the core's key tiles (128 keys at D=64, 64 at
    D=80): one key, inside the first tile, one short of, at and one past
    its end, inside the fourth; S=600 and 1000 end in a partial query
    block. The rows past valid_kv hold random values, which no read may
    reach and no weight may touch."""
    g = _gen(25)
    q, k, v = (torch.randn(2, s, d, device=dev, generator=g).bfloat16()
               for _ in range(3))
    got = attention.attention_nt(q, k, v, d ** -0.5, valid)
    want = attention.attention_nt_ref(q.float(), k.float(), v.float(),
                                      d ** -0.5, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("valid", [77, 600, 1000])
@pytest.mark.parametrize("d", [40, 64])
def test_attention_nt_kernel_negative_logits_and_a_tail_inside_a_tile(
        dev, valid, d):
    """Every real logit negative (q >= 0, k <= 0) and the keys past
    valid_kv zero rows, whose logit 0 would outweigh every real key if the
    kernel weighed them; valid_kv falls inside a 128-key tile."""
    g = _gen(26)
    shape = (3, 1024, d)
    q = torch.randn(shape, device=dev, generator=g).abs()
    k = -torch.randn(shape, device=dev, generator=g).abs()
    v = torch.randn(shape, device=dev, generator=g)
    k[:, valid:] = 0
    v[:, valid:] = 0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attention.attention_nt(q, k, v, d ** -0.5, valid)
    want = attention.attention_nt_ref(q.float(), k.float(), v.float(),
                                      d ** -0.5, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


def _unaligned(shape, dev, g, off):
    """A contiguous bf16 tensor of ``shape`` starting ``off`` elements into
    a buffer (8 bytes off a 16-byte boundary for off = 4)."""
    n = torch.Size(shape).numel()
    buf = torch.randn(n + off, device=dev, generator=g).bfloat16()
    return buf[off:].view(shape)


@pytest.mark.parametrize("layout", ["nt", "bshd"])
@pytest.mark.parametrize("case", ["head_dim_20", "offset_4"])
def test_layout_kernels_copy_what_their_tensor_maps_cannot_take(
        dev, layout, case):
    """B9 and B10 read q/k/v through TMA tensor maps: a head dim of 20 and
    a base 4 elements past an aligned one (D=24) are copied first (one
    count a call), then launched; the aligned inputs are not copied."""
    g = _gen(27)
    shape = (2, 600, 20) if layout == "nt" else (1, 512, 3, 20)
    if case == "offset_4":
        shape = shape[:-1] + (24,)
    d = shape[-1]
    if case == "offset_4":
        q, k, v = (_unaligned(shape, dev, g, 4) for _ in range(3))
    else:
        q, k, v = (torch.randn(shape, device=dev, generator=g).bfloat16()
                   for _ in range(3))
    aligned = [torch.randn(shape[:-1] + (24,), device=dev, generator=g)
               .bfloat16() for _ in range(3)]
    if layout == "nt":
        run = lambda *t: attention.attention_nt(*t, d ** -0.5, 450)
        plain = lambda *t: attention.attention_nt_ref(*t, d ** -0.5, 450)
    else:
        run = lambda *t: attention.attention_bshd(*t, d ** -0.5)
        plain = lambda *t: attention.attention_bshd_ref(*t, d ** -0.5)
    ops.reset_launch_counts()
    before = attention.staging_copies
    run(*aligned)
    assert attention.staging_copies == before
    got = run(q, k, v)
    want = plain(*(t.float() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert attention.staging_copies == before + 1
    assert ops.launch_counts()[f"attention_{layout}"] == 2
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


@pytest.mark.parametrize("h,s,d", [(1, 1024, 64), (3, 512, 40),
                                   (24, 512, 64)])
def test_attention_bshd_kernel_head_counts(dev, h, s, d):
    """B10 with one head (the map's head dim of extent 1), three, and
    SD3's 24 interleaved in each row."""
    g = _gen(28)
    q, k, v = (torch.randn(2, s, h, d, device=dev, generator=g).bfloat16()
               for _ in range(3))
    got = attention.attention_bshd(q, k, v, d ** -0.5)
    want = attention.attention_ref(q.float(), k.float(), v.float(),
                                   d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=ATTN_BF16_TOL, rtol=0)


def test_attention_core_refuses_a_grid_it_cannot_launch(dev):
    """B*H above 65535 blocks along gridDim.y: the C entries return
    cudaErrorInvalidValue (1) before touching memory rather than launching
    a grid that would leave heads unwritten."""
    from safe_denoiser_tpu_torch.ops import _build

    x = torch.zeros(1, 512, 64, device=dev).bfloat16()
    st = _build.stream_ptr(dev)
    p = x.data_ptr()
    nt = _build.library("attention_nt").sdt_attention_nt_bf16
    bshd = _build.library("attention_bshd").sdt_attention_bshd_bf16
    assert nt(p, p, p, p, 65536, 512, 64, 512, 0.1, st) == 1
    assert bshd(p, p, p, p, 2, 512, 32768, 64, 0.1, st) == 1
    assert nt(p, p, p, p, 1, 512, 64, 0, 0.1, st) == 1      # valid_kv < 1
    assert nt(p, p, p, p, 1, 512, 64, 513, 0.1, st) == 1    # > S
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,s,h,d,dtype", [
    (2, 600, 2, 40, torch.bfloat16), (2, 600, 2, 40, torch.float32),
    (1, 600, 3, 20, torch.bfloat16), (1, 600, 3, 20, torch.float16),
    (2, 4608, 24, 64, torch.bfloat16), (1, 600, 5, 3, torch.float32)])
def test_repack_kernels_are_bit_exact(dev, b, s, h, d, dtype):
    """B11/B12 against the plain versions and the library transposes,
    torch.equal: S=600 (no tile multiple), 40-byte head slices (the
    element path), SD3's joint shape, 12-byte f32 slices."""
    x = torch.randn(b, s, h * d, device=dev, generator=_gen(23)).to(dtype)
    heads = attention.repack_to_heads(x, h)
    torch.cuda.synchronize()
    assert torch.equal(heads, attention.repack_to_heads_ref(x, h))
    assert torch.equal(heads, x.view(b, s, h, d).transpose(1, 2).contiguous())
    back = attention.repack_from_heads(heads)
    torch.cuda.synchronize()
    assert torch.equal(back, attention.repack_from_heads_ref(heads))
    assert torch.equal(back, x)


def test_layout_wrappers_reject_what_the_kernels_do_not_take(dev):
    ops.reset_launch_counts()
    x = torch.randn(2, 512, 40, device=dev).bfloat16()
    for args in ((x.half(), x.half(), x.half(), 0.1),          # dtype
                 (x, x.float(), x, 0.1),                       # mixed
                 (x.transpose(0, 1).contiguous().transpose(0, 1), x, x, 0.1),
                 (x, x, x[:1], 0.1),                           # shapes
                 (x, x, x.cpu(), 0.1),                         # devices
                 (x, x, x, 0.1, 0), (x, x, x, 0.1, 513)):      # valid_kv
        with pytest.raises(ValueError):
            attention.attention_nt(*args)
    wide = torch.randn(1, 512, 264, device=dev).bfloat16()
    with pytest.raises(ValueError):
        attention.attention_nt(wide, wide, wide, 0.1)
    y = torch.randn(1, 600, 2, 40, device=dev).bfloat16()
    z = torch.randn(1, 512, 2, 40, device=dev).bfloat16()
    for args in ((y, y, y, 0.1), (z, z, z.transpose(1, 2).contiguous()
                                  .transpose(1, 2), 0.1),
                 (z.half(), z.half(), z.half(), 0.1)):
        with pytest.raises(ValueError):
            attention.attention_bshd(*args)
    r = torch.randn(1, 512, 80, device=dev).bfloat16()
    for fn, arg in ((lambda t: attention.repack_to_heads(t, 3), r),
                    (lambda t: attention.repack_to_heads(t, 2), r[:, ::2]),
                    (lambda t: attention.repack_to_heads(t, 2), r.double()),
                    (attention.repack_from_heads,
                     r.view(1, 512, 2, 40).transpose(1, 2))):
        with pytest.raises(ValueError):
            fn(arg)
    counts = ops.launch_counts()
    assert all(counts[n] == 0 for n in ("attention_nt", "attention_bshd",
                                        "repack_to_heads",
                                        "repack_from_heads"))


@pytest.mark.parametrize("layout,repack,s,int8,want", [
    ("nt", "0", 600, True, {"attention_nt": 1}),
    ("nt", "1", 600, True, {"attention_nt": 1, "repack_to_heads": 3,
                            "repack_from_heads": 1}),
    ("bshd", "0", 512, True, {"attention_bshd": 1}),
    ("bshd", "0", 600, True, {"attention_i8": 1}),
    ("bshd", "0", 600, False, {"attention": 1})])
def test_layout_switches_launch_their_kernels(dev, monkeypatch, layout,
                                              repack, s, int8, want):
    """The JAX package's branches on the GPU: each switch combination
    launches exactly its kernels, and the result is its plain version's
    (the int8-QK^T form's where B8 runs)."""
    monkeypatch.setenv("SDT_FLASH2_LAYOUT", layout)
    monkeypatch.setenv("SDT_ATTN_REPACK", repack)
    monkeypatch.setenv("SDT_INT8_ATTN", "1" if int8 else "0")
    g = _gen(24)
    q, k, v = (torch.randn(2, s, 3, 64, device=dev, generator=g).bfloat16()
               for _ in range(3))
    ops.reset_launch_counts()
    got = attention.self_attention(q, k, v, 0.125)
    plain = (attention.attention_i8_ref if "attention_i8" in want
             else attention.attention_ref)
    want_out = plain(q.float(), k.float(), v.float(), 0.125)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.launch_counts().items() if c} == want
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want_out, atol=ATTN_BF16_TOL,
                               rtol=0)


# --------------------------------------------------------------------- rbf
@pytest.mark.parametrize("n,m,d", [(1, 37, 1000), (16, 600, 4096),
                                   (4, 515, 16384), (3, 1, 128),
                                   (1, 16, 262144), (1, 3000, 16384),
                                   (1, 3001, 16384)])
@pytest.mark.parametrize("normalize", [True, False])
def test_rbf_kernel_matches_plain(dev, n, m, d, normalize):
    """Bank rows with |r|^2 ~ 4096, as a channel-normalized [4,64,64]
    latent has, and x near the first rows, so the weights span ~1e-2..1.
    Tolerance as chip_smoke.py's: f32 sums in another order, through the
    d^2 = |x|^2 + |r|^2 - 2G cancellation."""
    g = _gen(1)
    refs = torch.randn(m, d, device=dev, generator=g) * (4096 / d) ** 0.5
    x = refs[torch.arange(n, device=dev) % m] \
        + 0.1 * (4096 / d) ** 0.5 * torch.randn(n, d, device=dev, generator=g)
    num, beta = repellency_kernels.rbf_negative_score(
        x, refs, 3.15, 1e-8, normalize=normalize)
    wn, wb = repellency_kernels.rbf_negative_score_ref(
        x, refs, 3.15, 1e-8, normalize=normalize)
    torch.cuda.synchronize()
    torch.testing.assert_close(num, wn, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(beta, wb, atol=0.0, rtol=1e-4)


@pytest.mark.parametrize("n,m,d,offset", [
    (16, 515, 16384, 0),    # N = 16 at SD-v1's shape: 4 rows a block
    (2, 515, 4096, 0),      # 4 D-slices of 1024 columns, 8 rows a block
    (3, 300, 1000, 0),      # D = 1000; M 300 in runs of 38
    (5, 1003, 2052, 0),     # 3 D-slices, 8 runs of 126 rows (the last 121)
    (4, 77, 999, 0),        # D % 4 != 0: scalar loads
    (2, 41, 4096, 1)])      # x and refs 4 bytes off: scalar loads
def test_rbf_kernel_plans(dev, n, m, d, offset):
    """The cluster kernels at plans the main path does not take: M no
    multiple of its split (trailing runs empty), D = 1000 and odd, N = 16,
    pointers that are not 16-byte aligned. Bounds as
    test_rbf_kernel_matches_plain's."""
    g = _gen(21)
    buf = torch.randn(m * d + offset, device=dev, generator=g)
    refs = (buf[offset:] * (4096 / d) ** 0.5).view(m, d)
    xb = torch.randn(n * d + offset, device=dev, generator=g)
    x = xb[offset:].view(n, d)
    x.copy_(refs[torch.arange(n, device=dev) % m]
            + 0.1 * (4096 / d) ** 0.5 * x)
    aligned = (x.data_ptr() | refs.data_ptr()) % 16 == 0
    p = repellency_kernels.rbf_plan(n, m, d, 4 if d % 4 == 0 and aligned
                                    else 1)
    assert p.cl2 == 1 or m % p.ms
    assert p.vec == (1 if offset or d % 4 else 4)
    for normalize in (True, False):
        num, beta = repellency_kernels.rbf_negative_score(
            x, refs, 3.15, 1e-8, normalize=normalize)
        wn, wb = repellency_kernels.rbf_negative_score_ref(
            x, refs, 3.15, 1e-8, normalize=normalize)
        torch.cuda.synchronize()
        torch.testing.assert_close(num, wn, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(beta, wb, atol=0.0, rtol=1e-4)


def test_rbf_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ops.reset_launch_counts()
    refs = torch.randn(8, 256, device=dev)
    too_many = torch.randn(repellency_kernels.N_MAX + 1, 256, device=dev)
    for x, r in ((too_many, refs), (refs[:2].double(), refs.double()),
                 (refs[:2], refs[:, :128]), (refs[:2, ::2], refs[:, ::2])):
        with pytest.raises(ValueError):
            repellency_kernels.rbf_negative_score(x, r, 3.0)
    assert ops.launch_counts()["rbf"] == 0


# -------------------------------------------------------------- conv3x3_up
@pytest.mark.parametrize("b,h2,w2,ci,co,bias", [
    (2, 16, 16, 128, 128, True), (1, 8, 8, 32, 64, False),
    (3, 5, 7, 64, 128, True), (1, 33, 17, 96, 192, True),
    (2, 6, 10, 96, 64, True), (1, 12, 20, 96, 192, False),
    (2, 3, 8, 64, 128, True), (8, 32, 32, 640, 640, True)])
def test_conv3x3_up_kernel_matches_plain(dev, b, h2, w2, ci, co, bias):
    """Against the plain version in f32 on the same bf16 values; tolerance
    of the bf16 output (outputs ~ N(0, 2)) and the kernel's bf16
    pre-summed weights. (3, 5, 7) and (1, 33, 17) leave a partial 8 x 16
    pixel patch; Co = 64 and 192 a half 128-channel tile (masked), Ci = 32
    and 96 a half 64-channel chunk; (2, 3, 8) is less than one patch; the
    last is the UNet's 640-channel upsample."""
    g = _gen(2)
    h = torch.randn(b, h2, w2, ci, device=dev, generator=g).bfloat16()
    w = (torch.randn(co, ci, 3, 3, device=dev, generator=g)
         / (9 * ci) ** 0.5).bfloat16()
    bb = torch.randn(co, device=dev, generator=g).bfloat16() if bias else None
    got = conv3x3.conv3x3_up(h, w, bb)
    want = conv3x3.conv3x3_up_ref(h.float(), w.float(),
                                  None if bb is None else bb.float())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, 2 * h2, 2 * w2,
                                                         co)
    torch.testing.assert_close(got.float(), want, atol=5e-2, rtol=2e-2)


@pytest.mark.parametrize("b,h2,w2,ci,co", [
    (3, 8, 16, 128, 128), (3, 5, 20, 96, 192)])
def test_conv3x3_up_kernel_reads_no_neighbouring_pixels(dev, b, h2, w2, ci,
                                                        co):
    """Every image's outer rows and columns hold +-30: a kernel that reads
    a neighbouring image's row, wraps a column, or pads with anything but
    zeros is off by tens on the border outputs, far outside the bound.
    (3, 8, 16) fills whole patches, so the halo lies wholly outside. The
    weights are multiples of 2^-8 whose pre-summed parity sums are exact in
    bf16: with random bf16 weights the kernel's rounding of those sums
    alone reads up to 0.18 next to inputs of 30 (the plain version sums in
    f32), so only the bf16 output's rounding is left for the bound."""
    g = _gen(21)
    h = torch.randn(b, h2, w2, ci, device=dev, generator=g)
    sign = torch.where(torch.rand(h.shape, device=dev, generator=g) < 0.5,
                       -30.0, 30.0)
    edge = torch.zeros(h2, w2, dtype=torch.bool, device=dev)
    edge[[0, -1], :] = True
    edge[:, [0, -1]] = True
    h = torch.where(edge[None, :, :, None], sign, h).bfloat16()
    w = (torch.randint(-8, 9, (co, ci, 3, 3), device=dev, generator=g)
         / 256.0).bfloat16()
    bb = torch.randn(co, device=dev, generator=g).bfloat16()
    got = conv3x3.conv3x3_up(h, w, bb)
    want = conv3x3.conv3x3_up_ref(h.float(), w.float(), bb.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=5e-2, rtol=2e-2)


def test_conv3x3_up_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ops.reset_launch_counts()
    h = torch.randn(1, 8, 8, 64, device=dev).bfloat16()
    w = torch.randn(64, 64, 3, 3, device=dev).bfloat16()
    for hh, ww in ((h.float(), w), (h[..., :48], w[:, :48]),
                   (h.transpose(1, 2), w), (h, w[:32]), (h, w[:, :32]),
                   (h, w.cpu())):
        with pytest.raises(ValueError):
            conv3x3.conv3x3_up(hh, ww)
    wrong = conv3x3.pack_weights(torch.randn(128, 64, 3, 3, device=dev))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_up(h, w, packed=wrong)
    # the kernel reads the bias as 16-byte vectors
    wt, _ = conv3x3.pack_weights(w)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_up(h, w, packed=(wt, torch.zeros(65, device=dev)[1:]))
    assert ops.launch_counts()["conv3x3_up"] == 0


def test_upsample_module_with_packed_weights_matches_the_wrapper(dev):
    """The UNet/VAE upsample packs its weights once and reuses them; the
    result equals a call that packs per call, before and after the weights
    are reloaded."""
    from safe_denoiser_tpu_torch.models.unet import Upsample2D
    g = _gen(5)
    up = Upsample2D(128).to(dev, torch.bfloat16)
    x = torch.randn(2, 128, 16, 16, device=dev, generator=g).bfloat16()
    for _ in range(2):
        got = up(x)
        want = conv3x3.conv3x3_up(x.permute(0, 2, 3, 1).contiguous(),
                                  up.conv.weight, up.conv.bias)
        torch.testing.assert_close(got.permute(0, 2, 3, 1), want, atol=0,
                                   rtol=0)
        up.load_state_dict({k: torch.randn(v.shape, device=dev, generator=g)
                            for k, v in up.state_dict().items()})


@pytest.mark.parametrize("b,h2,w2,ci,co,bias", [
    (3, 5, 7, 64, 128, True), (1, 8, 8, 32, 64, False),
    (2, 16, 16, 128, 128, True), (1, 33, 17, 96, 192, True),
    (1, 6, 48, 256, 128, False)])
def test_conv3x3_up_interleave_kernel_matches_plain_and_planar(
        dev, b, h2, w2, ci, co, bias):
    """The interleaved upsample conv (B7) against the plain version in f32
    on the same bf16 values and against the planar kernel (B3), within
    B3's bound (the bf16 output and weights): (3, 5, 7) is all border, a
    partial 4 x 16 tile in both directions; Ci = 32 is one K step;
    (1, 33, 17) and (1, 6, 48) leave partial tiles with interior rows."""
    g = _gen(12)
    h = torch.randn(b, h2, w2, ci, device=dev, generator=g).bfloat16()
    w = (torch.randn(co, ci, 3, 3, device=dev, generator=g)
         / (9 * ci) ** 0.5).bfloat16()
    bb = torch.randn(co, device=dev, generator=g).bfloat16() if bias else None
    ops.reset_launch_counts()
    got = conv3x3.conv3x3_up(h, w, bb, form="interleave")
    planar = conv3x3.conv3x3_up(h, w, bb)
    want = conv3x3.conv3x3_up_ref(h.float(), w.float(),
                                  None if bb is None else bb.float())
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv3x3_up_interleave"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, 2 * h2, 2 * w2,
                                                         co)
    torch.testing.assert_close(got.float(), want, atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), planar.float(), atol=5e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,h2,w2,ci,co", [
    (3, 4, 16, 128, 128), (3, 5, 20, 96, 192)])
def test_conv3x3_up_interleave_kernel_reads_no_neighbouring_pixels(
        dev, b, h2, w2, ci, co):
    """B7 with every image's outer rows and columns at +-30, as B3's test:
    a kernel that reads a neighbouring image's row, wraps a column, pads
    with anything but zeros or takes a parity's taps at the wrong band
    offset is off by tens on the border outputs. (3, 4, 16) fills whole
    4 x 16 patches; (3, 5, 20) leaves ragged ones, Ci % 64 == 32 and three
    64-channel tiles. Dyadic weights exact in bf16 after pre-summing."""
    g = _gen(22)
    h = torch.randn(b, h2, w2, ci, device=dev, generator=g)
    sign = torch.where(torch.rand(h.shape, device=dev, generator=g) < 0.5,
                       -30.0, 30.0)
    edge = torch.zeros(h2, w2, dtype=torch.bool, device=dev)
    edge[[0, -1], :] = True
    edge[:, [0, -1]] = True
    h = torch.where(edge[None, :, :, None], sign, h).bfloat16()
    w = (torch.randint(-8, 9, (co, ci, 3, 3), device=dev, generator=g)
         / 256.0).bfloat16()
    bb = torch.randn(co, device=dev, generator=g).bfloat16()
    got = conv3x3.conv3x3_up(h, w, bb, form="interleave")
    want = conv3x3.conv3x3_up_ref(h.float(), w.float(), bb.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=5e-2, rtol=2e-2)


def test_conv3x3_up_interleave_wrapper_rejects_what_the_kernel_does_not_take(
        dev):
    ops.reset_launch_counts()
    h = torch.randn(1, 8, 8, 64, device=dev).bfloat16()
    w = torch.randn(64, 64, 3, 3, device=dev).bfloat16()
    for hh, ww in ((h.float(), w), (h[..., :48], w[:, :48]),
                   (h.transpose(1, 2), w), (h, w[:32]), (h, w[:, :32]),
                   (h, w.cpu())):
        with pytest.raises(ValueError):
            conv3x3.conv3x3_up(hh, ww, form="interleave")
    wrong = conv3x3.pack_weights(torch.randn(128, 64, 3, 3, device=dev))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_up(h, w, packed=wrong, form="interleave")
    assert ops.launch_counts()["conv3x3_up_interleave"] == 0


def test_vae_upsample_under_the_up_form_switch(dev, monkeypatch):
    """SDT_UP_FORM=interleave: the VAE's upsample launches B7 with its
    packed weights, bit-equal to the wrapper; the UNet's stays on B3. In
    no_grad, as sampling runs: the modules' weights require grad, and B7
    has no backward (it raises under autograd)."""
    from safe_denoiser_tpu_torch.models.unet import Upsample2D as UNetUp
    from safe_denoiser_tpu_torch.models.vae import Upsample2D as VAEUp
    monkeypatch.setenv("SDT_UP_FORM", "interleave")
    g = _gen(13)
    x = torch.randn(2, 128, 16, 16, device=dev, generator=g).bfloat16()
    vae_up = VAEUp(128).to(dev, torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = vae_up(x)
        UNetUp(128).to(dev, torch.bfloat16)(x)
        want = conv3x3.conv3x3_up(x.permute(0, 2, 3, 1).contiguous(),
                                  vae_up.conv.weight, vae_up.conv.bias,
                                  form="interleave")
    torch.testing.assert_close(got.permute(0, 2, 3, 1), want, atol=0, rtol=0)
    counts = ops.launch_counts()
    assert (counts["conv3x3_up_interleave"], counts["conv3x3_up"]) == (2, 1)


# ----------------------------------------------------------------- conv3x3
def _conv3x3_case(b, h, w, ci, co, seed):
    """NHWC bf16 x and residual, bf16 weights, f32 bias and GN affine."""
    g = _gen(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    x = randn(b, h, w, ci).bfloat16()
    wt = (randn(co, ci, 3, 3) / (9 * ci) ** 0.5).bfloat16()
    res = randn(b, h, w, co).bfloat16()
    return (x, wt, 0.1 * randn(co), 1.0 + 0.2 * randn(b, ci),
            0.5 * randn(b, ci), res)


def _assert_b4_close(got, want):
    torch.testing.assert_close(got.float(), want.float(),
                               atol=conv3x3.BF16_ATOL, rtol=conv3x3.BF16_RTOL)


@pytest.mark.parametrize("b,h,w,ci,co", [
    (2, 18, 16, 128, 128), (1, 5, 16, 32, 128), (3, 10, 24, 256, 128),
    (1, 16, 48, 128, 256)])
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("with_res", [False, True])
def test_conv3x3_kernel_matches_plain(dev, b, h, w, ci, co, pre, act,
                                      with_res):
    """Against the plain version on the same bf16 values: H = 16 + 2, W =
    16, a partial pixel tile (1x5x16 = 80 pixels), Ci != Co with B > 1, two
    output-channel tiles; each of the prologue's affine, the SiLU and the
    residual on and off. Bound: conv3x3.BF16_ATOL/RTOL (the bf16 output
    and the prologue's bf16 roundings, which differ by an ulp between the
    kernel's x/(1+exp(-x)) and the plain x*sigmoid(x))."""
    x, wt, bias, a, s, res = _conv3x3_case(b, h, w, ci, co, seed=6)
    kw = dict(pre_scale=a if pre else None, pre_shift=s if pre else None,
              act=act, residual=res if with_res else None)
    got = conv3x3.conv3x3(x, wt, bias, **kw)
    want = conv3x3.conv3x3_ref(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, co)
    _assert_b4_close(got, want)


@pytest.mark.parametrize("b,h,w,ci,co,with_res", [
    (4, 64, 64, 512, 512, False), (4, 256, 256, 512, 256, False),
    (4, 512, 512, 128, 128, True), (16, 512, 512, 128, 128, True),
    (16, 256, 256, 128, 256, False), (16, 256, 256, 256, 256, True),
    (16, 128, 128, 256, 512, False), (16, 128, 128, 512, 512, True),
    (16, 64, 64, 512, 512, True)])
def test_conv3x3_kernel_at_the_vae_shapes(dev, b, h, w, ci, co, with_res):
    """B4 at the SD-v1 decoder's three timed shapes (batch 4: the first
    resnet conv at 64^2 x 512, the 512 -> 256 conv at 256^2, a 128-channel
    conv2 with the residual at 512^2) and at the bank encoder's batch-16
    shapes, with the GroupNorm affine and the SiLU in the prologue."""
    x, wt, bias, a, s, res = _conv3x3_case(b, h, w, ci, co, seed=13)
    r = res if with_res else None
    got = conv3x3.conv3x3(x, wt, bias, a, s, "silu", r)
    want = conv3x3.conv3x3_ref(x, wt, bias, a, s, "silu", r)
    torch.cuda.synchronize()
    _assert_b4_close(got, want)


@pytest.mark.parametrize("b,h,w,ci,co", [(2, 18, 16, 128, 128),
                                         (1, 8, 32, 256, 128)])
def test_conv3x3_kernel_pads_after_the_prologue(dev, b, h, w, ci, co):
    """SAME padding holds zeros of act(x*a + b), not act(0*a + b): with a
    shift of 4, silu(b_c) ~ 3.9 everywhere, so a kernel that pads x before
    its prologue is off by ~sum(w) * 3.9 on every border pixel. Only the
    outer rows and columns are compared."""
    x, wt, bias, a, s, res = _conv3x3_case(b, h, w, ci, co, seed=7)
    s = torch.full_like(s, 4.0)
    got = conv3x3.conv3x3(x, wt, bias, 0.1 * a, s, "silu")
    want = conv3x3.conv3x3_ref(x, wt, bias, 0.1 * a, s, "silu")
    torch.cuda.synchronize()
    for sl in ((slice(None), 0), (slice(None), -1),
               (slice(None), slice(None), 0), (slice(None), slice(None), -1)):
        _assert_b4_close(got[sl], want[sl])


def test_conv3x3_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ops.reset_launch_counts()
    x, wt, bias, a, s, res = _conv3x3_case(1, 8, 16, 128, 128, seed=8)
    nchw_res = res.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    x48 = torch.randn(1, 8, 16, 48, device=dev).bfloat16()
    bad = (
        dict(x=x.float()),                                  # not bf16
        dict(residual=nchw_res),                            # not NHWC-dense
        dict(x=x48, w=torch.randn(128, 48, 3, 3, device=dev).bfloat16()),
        dict(w=wt[:64]),                                    # Co % 128
        dict(w=wt[:, :64]),                                 # weight vs Ci
        dict(pre_scale=a[:, :64], pre_shift=s[:, :64]),
        dict(pre_scale=a),                                  # shift missing
        dict(act="gelu"),
        dict(w=wt.cpu()),
        dict(x=x.transpose(1, 2)),
    )
    for case in bad:
        kw = dict(x=x, w=wt, b=bias, pre_scale=None, pre_shift=None,
                  act=None, residual=None)
        kw.update(case)
        with pytest.raises(ValueError):
            conv3x3.conv3x3(kw.pop("x"), kw.pop("w"), **kw)
    wrong = conv3x3.pack_weights_3x3(torch.randn(256, 128, 3, 3, device=dev))
    with pytest.raises(ValueError):
        conv3x3.conv3x3(x, wt, packed=wrong)
    assert ops.launch_counts()["conv3x3"] == 0


def test_vae_resnet_on_gpu_matches_the_cpu(dev):
    """The VAE resnet block in its fused form (GN coefficients, two fused
    convs, the residual in conv2's epilogue) on channels_last GPU tensors
    against the same block on the CPU (plain versions), bf16, Ci != Co and
    Ci == Co; rms of the difference relative to the output's rms."""
    from safe_denoiser_tpu_torch.models.vae import ResnetBlock2D
    g = torch.Generator().manual_seed(9)
    for ci, co in ((128, 256), (256, 256)):
        torch.manual_seed(ci)
        blk = ResnetBlock2D(ci, co, 32).bfloat16()
        x = torch.randn(2, ci, 32, 32, generator=g).bfloat16()
        with torch.no_grad():
            want = blk(x).float()
            ops.reset_launch_counts()
            got = blk.to(dev)(x.to(dev).contiguous(
                memory_format=torch.channels_last)).float().cpu()
        assert ops.launch_counts()["conv3x3"] == 2
        rel = ((got - want).pow(2).mean() / want.pow(2).mean()).sqrt()
        assert rel.item() <= 1e-2, (ci, co, rel.item())


# ---------------------------------------------------------------- gn_stats
@pytest.mark.parametrize("shape,dtype", [
    ((2, 1000, 96), torch.bfloat16), ((1, 4096, 320), torch.float32),
    ((3, 33, 130), torch.float16), ((1, 1, 128), torch.bfloat16)])
def test_gn_stats_kernel_matches_plain(dev, shape, dtype):
    """Channels and rows that are not multiples of the Triton tile; the
    sums relative to the sum of |x| (another order of summation)."""
    g = _gen(3)
    x = (torch.randn(*shape, device=dev, generator=g) + 0.5).to(dtype)
    s1, s2 = group_norm.gn_stats(x)
    w1, w2 = group_norm.gn_stats_ref(x)
    torch.cuda.synchronize()
    scale = x.float().abs().sum(1)
    assert ((s1 - w1).abs() / scale).max().item() <= 1e-5
    assert ((s2 - w2).abs() / w2).max().item() <= 1e-5


def test_gn_stats_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ops.reset_launch_counts()
    x = torch.randn(2, 64, 128, device=dev)
    for bad in (x.double(), x.transpose(1, 2), x[0]):
        with pytest.raises(ValueError):
            group_norm.gn_stats(bad)
    assert ops.launch_counts()["gn_stats"] == 0


# ---------------------------------------------------------------- gn_fused
def _bf16_ulp(m: float) -> float:
    return 2.0 ** (torch.tensor(m).log2().floor().item() - 7)


@pytest.mark.parametrize("b,s,c,groups", [
    (2, 64, 2560, 32), (2, 300, 320, 32), (1, 4096, 320, 32),
    (3, 33, 96, 8), (2, 1024, 1280, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_fused_kernel_matches_plain(dev, b, s, c, groups, dtype,
                                               act):
    """The fused GroupNorm (B6) against its plain version on the same
    values: S = 64 with C = 2560 (group width 80), group widths 10 and 12
    (not powers of two), rows that are no multiple of the block, the UNet's
    two largest admitted shapes. x ~ N(5, 2^2), where the one-pass
    variance cancels most. f32 within 5e-5 + 1e-5 |plain| (sums in another
    order); bf16 within one bf16 ulp of max|y| (the same f32 values may
    round to neighbouring bf16 values)."""
    gen = _gen(14)
    x = (torch.randn(b, s, c, device=dev, generator=gen) * 2 + 5).to(dtype)
    sc = 1 + 0.5 * torch.randn(c, device=dev, generator=gen)
    bi = 0.5 * torch.randn(c, device=dev, generator=gen)
    ops.reset_launch_counts()
    got = group_norm.group_norm_fused(x, sc, bi, groups, act=act)
    want = group_norm.group_norm_fused_ref(x, sc, bi, groups, act=act)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gn_fused"] == 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-5)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _bf16_ulp(want.float().abs().max().item()), err


def _gn_inputs(b, s, c, dtype, seed, offset=0):
    gen = _gen(seed)
    buf = torch.empty(b * s * c + offset, device="cuda", dtype=dtype)
    x = buf[offset:].view(b, s, c)
    x.copy_(torch.randn(b, s, c, device="cuda", generator=gen) * 2 + 5)
    sc = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
    bi = 0.5 * torch.randn(c, device="cuda", generator=gen)
    return x, sc, bi


def _assert_gn_close(got, want):
    """f32 within 5e-5 + 1e-5 |plain|; bf16 and f16 within one ulp of
    max|y| in their type (test_group_norm_fused_kernel_matches_plain's)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-5)
        return
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    bits = 7 if got.dtype == torch.bfloat16 else 10
    assert err <= 2.0 ** (torch.tensor(top).log2().floor().item() - bits), err


@pytest.mark.parametrize("b,s,c,dtype", [
    (8, 4096, 320, torch.bfloat16), (8, 4096, 320, torch.float32),
    (8, 64, 2560, torch.bfloat16), (2, 300, 160, torch.float16)])
def test_group_norm_fused_kernel_one_read_and_reread_forms(dev, b, s, c,
                                                           dtype):
    """The one-read form (a block's slice in shared memory) and the re-read
    form at one shape: the same walk and sums, so bit-equal outputs, each
    within the plain version's bound."""
    x, sc, bi = _gn_inputs(b, s, c, dtype, 15)
    groups = 32
    assert group_norm.gn_plan(b, s, c, groups, x.element_size()).resident
    one = group_norm._group_norm_fused_cuda(x, sc, bi, groups, 1e-5, "silu")
    again = group_norm._group_norm_fused_cuda(x, sc, bi, groups, 1e-5,
                                              "silu", one_read=False)
    want = group_norm.group_norm_fused_ref(x, sc, bi, groups, 1e-5, "silu")
    torch.cuda.synchronize()
    assert torch.equal(one, again)
    _assert_gn_close(one, want)


@pytest.mark.parametrize("b,s,c,groups,dtype,offset,vb", [
    (2, 300, 60, 6, torch.bfloat16, 0, 4),    # 20-byte tile rows
    (2, 100, 96, 8, torch.bfloat16, 0, 8),    # 24-byte tile rows
    (2, 77, 33, 3, torch.bfloat16, 0, 2),     # 22-byte tile rows
    (2, 77, 33, 3, torch.float16, 0, 2),
    (2, 50, 45, 5, torch.float32, 0, 4),      # 36-byte f32 tile rows
    (2, 300, 320, 32, torch.bfloat16, 2, 4),  # x 4 bytes off 16
    (1, 129, 96, 8, torch.float32, 2, 8)])    # x 8 bytes off 16
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_fused_kernel_narrow_vectors(dev, b, s, c, groups, dtype,
                                                offset, vb, act):
    """Tiles whose row segments, row pitch or base pointer are not 16-byte
    aligned take 8-, 4- or 2-byte vectors (plain copies at 2) instead of
    being refused."""
    x, sc, bi = _gn_inputs(b, s, c, dtype, 16, offset)
    p = group_norm.gn_plan(b, s, c, groups, x.element_size(),
                           group_norm._align(x))
    assert p.vb == vb, p
    ops.reset_launch_counts()
    got = group_norm.group_norm_fused(x, sc, bi, groups, act=act)
    want = group_norm.group_norm_fused_ref(x, sc, bi, groups, act=act)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gn_fused"] == 1
    _assert_gn_close(got, want)


def test_cluster_kernels_are_deterministic(dev):
    """The cluster reductions add in rank order, with no atomics: two calls
    give bit-equal outputs (B6 at the UNet's largest shape in bf16 and f32,
    B2 at SD-v1's and SD3's)."""
    for dtype in (torch.bfloat16, torch.float32):
        x, sc, bi = _gn_inputs(8, 4096, 320, dtype, 17)
        outs = [group_norm.group_norm_fused(x, sc, bi, 32, 1e-5, "silu")
                for _ in range(2)]
        assert torch.equal(*outs), dtype
    g = _gen(18)
    for n, m, d in ((4, 515, 16384), (1, 16, 262144)):
        refs = torch.randn(m, d, device=dev, generator=g)
        x = refs[:n] + 0.1 * torch.randn(n, d, device=dev, generator=g)
        (n1, b1), (n2, b2) = (repellency_kernels.rbf_negative_score(
            x, refs, 3.15) for _ in range(2))
        assert torch.equal(n1, n2) and torch.equal(b1, b2), (n, m, d)


def test_group_norm_fused_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ops.reset_launch_counts()
    x = torch.randn(2, 64, 128, device=dev)
    sc, bi = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    for args, kw in (((x.double(), sc, bi, 32), {}),
                     ((x.transpose(1, 2), sc, bi, 32), {}),
                     ((x[0], sc, bi, 32), {}), ((x, sc, bi, 48), {}),
                     ((x, sc[:64], bi, 32), {}), ((x, sc.cpu(), bi, 32), {}),
                     ((x, sc, bi, 32), {"act": "gelu"})):
        with pytest.raises(ValueError):
            group_norm.group_norm_fused(*args, **kw)
    assert ops.launch_counts()["gn_fused"] == 0


def test_group_norm_dispatch_under_the_fused_switch(dev, monkeypatch):
    """SDT_FUSED_GN=1: the UNet's GroupNorm module launches B6 where the
    gate admits the shape (C 320 at 64^2) and the plain form with B5's
    statistics where it does not (C 640 at 64^2). In no_grad, as sampling
    runs: the module's weights require grad, and B6 has no backward."""
    from safe_denoiser_tpu_torch.models.layers import GroupNorm32
    monkeypatch.setenv("SDT_FUSED_GN", "1")
    for c, want in ((320, (1, 0)), (640, (0, 1))):
        gn = GroupNorm32(c, 32, 1e-5, act="silu").to(dev, torch.bfloat16)
        x = torch.randn(2, c, 64, 64, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last)
        ops.reset_launch_counts()
        with torch.no_grad():
            gn(x)
        counts = ops.launch_counts()
        assert (counts["gn_fused"], counts["gn_stats"]) == want, c


# ----------------------------------------------------------------- counts
def test_each_wrapper_call_counts_one_launch(dev):
    """One count per wrapper call, though rbf and gn_stats each run two
    device kernels."""
    ops.reset_launch_counts()
    x = torch.randn(1, 512, 2, 40, device=dev).bfloat16()
    attention.self_attention(x, x, x, 0.1)
    _i8(x, x, x, 0.1)
    repellency_kernels.rbf_negative_score(torch.randn(2, 128, device=dev),
                                          torch.randn(5, 128, device=dev),
                                          3.0)
    for form in conv3x3.UP_FORMS:
        conv3x3.conv3x3_up(
            torch.randn(1, 16, 16, 128, device=dev).bfloat16(),
            torch.randn(128, 128, 3, 3, device=dev).bfloat16(), form=form)
    conv3x3.conv3x3(torch.randn(1, 8, 16, 128, device=dev).bfloat16(),
                    torch.randn(128, 128, 3, 3, device=dev).bfloat16())
    group_norm.gn_stats(torch.randn(1, 16384, 128, device=dev))
    group_norm.group_norm_fused(torch.randn(1, 4096, 320, device=dev),
                                torch.randn(320, device=dev),
                                torch.randn(320, device=dev), 32)
    y = x.reshape(2, 512, 40).contiguous()
    attention.attention_nt(y, y, y, 0.1)
    attention.attention_bshd(x, x, x, 0.1)
    attention.repack_from_heads(attention.repack_to_heads(
        x.reshape(1, 512, 80), 2))
    row = torch.randn(2, 256, device=dev).bfloat16()
    adaln.adaln(torch.randn(2, 16, 256, device=dev).bfloat16(), row, row)
    ones = torch.ones(64, device=dev).bfloat16()
    seg = tuple(torch.randn(1, 8, 2, 64, device=dev).bfloat16()
                for _ in range(3)) + (ones, ones)
    qk_rope.qk_rope([seg, seg], torch.ones(16, 64, device=dev),
                    torch.zeros(16, 64, device=dev))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert set(counts.values()) == {1}, counts


# ------------------------------------------- repellency methods and Q16
def test_sparse_force_on_gpu_matches_the_cpu(dev):
    """The SPELL force (plain PyTorch) at SD-v1's shape, a channel-
    normalized [515, 4, 64, 64] bank and x0 [4, 4, 64, 64] near its first
    rows, radius 60 (some pairs in range): force and coefficient sums
    within f32 round-off of the CPU's."""
    g = torch.Generator().manual_seed(5)
    bank = torch.randn(515, 4, 64, 64, generator=g)
    bank = (bank / bank.norm(dim=1, keepdim=True)).reshape(515, -1)
    x = bank[:4] + 0.3 * torch.randn(4, bank.shape[1], generator=g)
    want = repellency_kernels.sparse_repellency_force(x, bank, 60.0)
    got = repellency_kernels.sparse_repellency_force(x.to(dev), bank.to(dev),
                                                     60.0)
    assert bool((want[1] > 0).all())
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(got[1].cpu(), want[1], atol=1e-5, rtol=1e-4)


def test_lsh_bucket_scores_on_gpu_match_the_cpu(dev):
    from safe_denoiser_tpu_torch.repellency.lsh import _bucket_scores
    g = torch.Generator().manual_seed(6)
    refs = torch.randn(515, 16384, generator=g)
    x = refs[:4] + 0.05 * torch.randn(4, 16384, generator=g)
    idx = torch.randint(0, 515, (4, 64), generator=g)
    idx[:, 0] = torch.arange(4)
    mask = (torch.rand(4, 64, generator=g) > 0.3).float()
    mask[:, 0] = 1.0
    mask[3] = 0.0                                       # an empty bucket
    kw = dict(sigma=40.0, scale=0.5, epsilon=1e-8)
    want = _bucket_scores(x, refs, idx, mask, **kw)
    got = _bucket_scores(x.to(dev), refs.to(dev), idx.to(dev),
                         mask.to(dev), **kw)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)
    assert torch.equal(got[3].cpu(), x[3])


def test_q16_eval_on_gpu_matches_the_cpu(dev, tmp_path):
    """Q16Eval with a ViT-B/32-shaped random tower (12 layers, width 768)
    on cuda against the CPU: embeddings within f32 round-off, the same
    decisions."""
    import pickle

    import numpy as np

    from safe_denoiser_tpu_torch.evals.q16 import Q16Eval
    from safe_denoiser_tpu_torch.models import (CLIP_VISION_VIT_B_32,
                                                CLIPVisionModel)
    torch.manual_seed(0)
    sd = CLIPVisionModel(CLIP_VISION_VIT_B_32).state_dict()
    pk = tmp_path / "q16.p"
    pk.write_bytes(pickle.dumps(np.random.RandomState(0).randn(
        2, 512).astype(np.float32)))
    rs = np.random.RandomState(1)
    imgs = [rs.randint(0, 256, (512, 512, 3), dtype=np.uint8)
            for _ in range(6)]
    evs = {d: Q16Eval(str(pk), vision_state_dict=sd,
                      vision_config=CLIP_VISION_VIT_B_32, device=d)
           for d in ("cpu", "cuda")}
    e_cpu = evs["cpu"].compute_embeddings(imgs)
    e_gpu = evs["cuda"].compute_embeddings(imgs).cpu()
    torch.testing.assert_close(e_gpu, e_cpu, atol=1e-4, rtol=1e-4)
    groups = [[im] for im in imgs]
    assert [u for u, _ in evs["cuda"].eval_many(groups)] == \
        [u for u, _ in evs["cpu"].eval_many(groups)]


@pytest.fixture
def tf32_on():
    """PyTorch's TF32 switches on (cuDNN's default) around the test; the
    evaluators must compute in f32 all the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _rel_close(a, b, rtol=1e-4):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    assert (a - b).abs().max().item() <= rtol * b.abs().max().item()


def _tiny_clip(seed):
    """A tiny CLIP text tower (the tiny BPE vocab's 521 ids) with its
    projection and a tiny 224^2 vision tower, seeded."""
    from safe_denoiser_tpu_torch.models import (CLIPTextConfig,
                                                CLIPTextModel,
                                                CLIPVisionConfig,
                                                CLIPVisionModel)
    vcfg = CLIPVisionConfig(patch_size=56, hidden_size=32, num_layers=2,
                            num_heads=2, intermediate_size=64,
                            projection_dim=16, hidden_act="gelu")
    tcfg = CLIPTextConfig(vocab_size=521, hidden_size=32, num_layers=2,
                          num_heads=2, intermediate_size=64,
                          projection_dim=16, eos_token_id=520,
                          hidden_act="gelu")
    torch.manual_seed(seed)
    return (vcfg, tcfg, CLIPVisionModel(vcfg).state_dict(),
            CLIPTextModel(tcfg, with_projection=True).state_dict())


def test_evaluator_towers_compute_in_f32_under_tf32_switches(tf32_on):
    """InceptionFeatures (94 cuDNN convs) and OpenCLIPModel (cuBLAS) on
    cuda with TF32 allowed globally, against the CPU: within 1e-4 of the
    largest magnitude (TF32's 10-bit mantissa would miss it), and the
    switches are as they were afterwards."""
    import numpy as np

    from safe_denoiser_tpu_torch.evals.offline import InceptionFeatures
    from safe_denoiser_tpu_torch.models.openclip_factory import OpenCLIPModel
    x = np.random.RandomState(0).rand(2, 299, 299, 3).astype(np.float32)
    feats = {d: InceptionFeatures(allow_random_init=True,
                                  device=d).features(x)
             for d in ("cpu", "cuda")}
    for got, want in zip(feats["cuda"], feats["cpu"]):
        _rel_close(got, want)
    vcfg, tcfg, vsd, tsd = _tiny_clip(1)
    px = torch.randn(3, 3, 224, 224, generator=torch.Generator()
                     .manual_seed(2))
    ids = torch.tensor([[519, 70, 71, 520] + [520] * 73])
    models = {d: OpenCLIPModel(vcfg, tcfg, vsd, tsd, device=d)
              for d in ("cpu", "cuda")}
    _rel_close(models["cuda"].encode_image(px),
               models["cpu"].encode_image(px))
    _rel_close(models["cuda"].encode_text(ids), models["cpu"].encode_text(ids))
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_in_loop_clip_score_on_gpu_matches_the_cpu(tf32_on, tmp_path,
                                                   monkeypatch):
    """InLoopClipScore from an HF-named directory of tiny towers (in place
    of ViT-B/32's configs) with the tiny vocab as tokenizer/: the scores
    of 512^2 images (bicubic to 224) on cuda within 1e-4 of the CPU's."""
    import numpy as np

    import chip_smoke
    from safe_denoiser_tpu_torch.runners import coco30k
    vcfg, tcfg, vsd, tsd = _tiny_clip(3)
    monkeypatch.setattr(coco30k, "CLIP_VISION_VIT_B_32", vcfg)
    monkeypatch.setattr(coco30k, "CLIP_TEXT_VIT_B_32", tcfg)
    chip_smoke.write_safetensors(str(tmp_path / "model.safetensors"),
                                 {**vsd, **tsd})
    (tmp_path / "tokenizer").mkdir()
    chip_smoke.write_tiny_vocab(str(tmp_path / "tokenizer"))
    scorers = {d: coco30k.InLoopClipScore(str(tmp_path), device=d)
               for d in ("cpu", "cuda")}
    rs = np.random.RandomState(4)
    for prompt in ("a cat", "a dog on the beach"):
        img = rs.randint(0, 256, (512, 512, 3), dtype=np.uint8)
        want = scorers["cpu"](img, prompt)
        assert abs(scorers["cuda"](img, prompt) - want) <= \
            1e-4 * max(abs(want), 1.0)


# ------------------------------------------------------------ CUDA graphs
@pytest.fixture
def graph_pipe(dev, tmp_path):
    """A tiny f32 SD-v1 pipeline on the GPU at 32^2 latents (S = 1024 at
    the UNet's first level and the VAE's mid-block: B1's f32 entry), with
    kernel_fast against a random bank, and its batch arguments."""
    import chip_smoke
    from safe_denoiser_tpu_torch.models import (CLIPTextConfig, UNetConfig,
                                                VAEConfig)
    from safe_denoiser_tpu_torch.pipeline import EraseSpec, RepellencyWindow
    from safe_denoiser_tpu_torch.repellency import KernelFastRepellency

    chip_smoke.write_tiny_vocab(str(tmp_path))
    pipe = chip_smoke.build_random_pipeline(
        dev, str(tmp_path),
        UNetConfig(sample_size=32, block_out_channels=(32, 64),
                   layers_per_block=1, cross_attention_dim=32,
                   num_attention_heads=2, norm_num_groups=8),
        VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                  norm_num_groups=8),
        CLIPTextConfig(vocab_size=528, hidden_size=32, num_layers=2,
                       num_heads=2, intermediate_size=64),
        dtype=torch.float32)
    bank = torch.randn(6, 4, 32, 32, device=dev, generator=_gen(1))
    proc = KernelFastRepellency(ref_data=bank, embed_fn=lambda x: x,
                                sigma=30.0, scale=0.4, beta_threshold=1e-12)
    kw = dict(num_inference_steps=4, height=64, width=64,
              repellency_processor=proc,
              erase_spec=EraseSpec(repellency=True,
                                   window=RepellencyWindow(1000.0, 300.0)))
    return pipe, kw


def test_graph_equals_eager_bit_for_bit(graph_pipe):
    """The graphed loop and decode against the eager body on the same
    buffers (same inputs, same noise): equal bit for bit; the replay's
    launch counts equal the eager run's."""
    from safe_denoiser_tpu_torch.pipeline import graph

    pipe, kw = graph_pipe
    program, bufs = pipe._prepare_batch(["a cat", "a dog"], [3, 4],
                                        [7.5, 5.0], **kw)
    ops.reset_launch_counts()
    pending = pipe._launch(program, bufs)
    pending.fetch()
    graphed = ops.launch_counts()
    ops.reset_launch_counts()
    lat, applied, image = graph._run_eager(program, bufs)
    torch.cuda.synchronize()
    assert ops.launch_counts() == graphed
    # 4 DDPM steps (t = 751, 501, 251, 1): 2 inside [1000, 300]
    assert graphed["attention"] > 0 and graphed["rbf"] == 2
    assert "capture" in pending.stage_ms
    assert torch.equal(pending.latents, lat)
    assert torch.equal(pending.applied, applied) and bool(applied.any())
    assert torch.equal(pending.image, image)


def test_graph_counts_per_replay_and_keeps_outputs(graph_pipe):
    """Each replay adds one batch's launches (none counted at capture);
    a batch's outputs survive the next batch's replay (they are clones);
    a new key captures anew."""
    pipe, kw = graph_pipe
    ops.reset_launch_counts()
    first = pipe.dispatch_batch(["a cat", "a dog"], [3, 4], [7.5, 5.0], **kw)
    one = ops.launch_counts()
    kept = first.latents.clone()
    second = pipe.dispatch_batch(["a cat", "a dog"], [5, 6], [7.5, 5.0],
                                 **kw)
    first.fetch(), second.fetch()
    assert ops.launch_counts() == {k: 2 * v for k, v in one.items()}
    assert "capture" in first.stage_ms and "capture" not in second.stage_ms
    assert torch.equal(first.latents, kept)
    assert not torch.equal(first.latents, second.latents)
    again = pipe.dispatch_batch(["a cat", "a dog"], [3, 4], [7.5, 5.0], **kw)
    assert torch.equal(again.latents, kept)
    three = pipe.dispatch_batch(["a cat", "a dog"], [3, 4], [7.5, 5.0],
                                **{**kw, "num_inference_steps": 3})
    three.fetch()
    assert "capture" in three.stage_ms


def test_graph_replays_weights_loaded_in_place(graph_pipe):
    """A graph captured before ``load_state_dict`` does not replay stale
    weights: the copy moves the weights' versions, which the program's key
    holds (``graph.weights_version``: a weight packed at capture, B3's,
    would otherwise stay old), so the batch captures anew and equals the
    eager body on the new weights."""
    from safe_denoiser_tpu_torch.pipeline import graph

    pipe, kw = graph_pipe
    args = (["a cat", "a dog"], [3, 4], [7.5, 5.0])
    before = pipe.dispatch_batch(*args, **kw).fetch(return_latents=True)
    sd = {k: v + 0.01 if v.is_floating_point() else v
          for k, v in pipe.unet.state_dict().items()}
    pipe.unet.load_state_dict(sd)
    program, bufs = pipe._prepare_batch(*args, **kw)
    after = pipe._launch(program, bufs)
    after.fetch()
    assert "capture" in after.stage_ms
    want = graph._run_eager(program, bufs)[0]
    assert torch.equal(after.fetch(return_latents=True), want)
    assert not torch.equal(before, want)


def test_graph_recaptures_after_load_lora(graph_pipe, tmp_path):
    """A graph captured before ``load_lora`` does not replay stale weights:
    the merge moves the weights' versions, the next batch captures anew
    and equals the eager body on the merged weights."""
    from safe_denoiser_tpu_torch.pipeline import graph
    from safe_denoiser_tpu_torch.training import init_lora_params, save_lora

    pipe, kw = graph_pipe
    args = (["a cat", "a dog"], [3, 4], [7.5, 5.0])
    before = pipe.dispatch_batch(*args, **kw).fetch(return_latents=True)
    sd = {n: p.detach() for n, p in pipe.unet.named_parameters()}
    lora = init_lora_params(sd, _gen(0), 2, "xattn",
                            model_cfg=pipe.unet.config)
    for ab in lora.values():
        ab["b"].normal_(0, 0.2, generator=_gen(1))
    path = str(tmp_path / "adapter.safetensors")
    save_lora(path, lora, 2)
    pipe.load_lora(path)
    program, bufs = pipe._prepare_batch(*args, **kw)
    after = pipe._launch(program, bufs)
    after.fetch()
    assert "capture" in after.stage_ms
    want = graph._run_eager(program, bufs)[0]
    assert torch.equal(after.fetch(return_latents=True), want)
    assert not torch.equal(before, want)


# ------------------------------------------ backward kernels (B1b, B5b, B3b)
def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("b,s,h,d", [
    (1, 600, 2, 40), (2, 512, 1, 64), (1, 1000, 2, 80), (1, 520, 3, 16),
    (1, 700, 1, 128), (1, 77, 2, 40)])
def test_attention_backward_matches_plain(dev, b, s, h, d):
    """B1b against its plain backward in f32 on the same bf16 values,
    within chip_smoke.BWD_B1_RTOL of each output's largest entry: tails
    past the 64-row blocks, head dims padded to 16 (16..128); two calls
    give the same bits."""
    import chip_smoke
    q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=_gen(i))
                   .to(torch.bfloat16) for i in range(4))
    scale = d ** -0.5
    o = attention.attention_ref(q, k, v, scale)
    ops.reset_launch_counts()
    got = attention._attention_bwd_cuda(q, k, v, o, do, scale)
    again = attention._attention_bwd_cuda(q, k, v, o, do, scale)
    want = attention.attention_bwd_ref(*(t.float() for t in (q, k, v, o, do)),
                                       scale)
    assert ops.backward_launch_counts()["attention_bwd"] == 2
    for x, y, z in zip(got, again, want):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
        assert _rel(x, z) <= chip_smoke.BWD_B1_RTOL


def test_attention_backward_through_autograd(dev):
    """Under autograd bf16 self-attention goes through SelfAttention: its
    forward is B1's no-grad output bit for bit, its gradients B1b's."""
    q, k, v, do = (torch.randn(1, 1024, 2, 40, device=dev, generator=_gen(i))
                   .to(torch.bfloat16) for i in range(4))
    want_o = attention.self_attention(q, k, v, 0.15)
    want = attention._attention_bwd_cuda(q, k, v, want_o, do, 0.15)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    out = attention.self_attention(qg, kg, vg, 0.15)
    assert torch.equal(out.detach(), want_o)
    out.backward(do)
    assert ops.launch_counts()["attention"] == 1
    assert ops.backward_launch_counts()["attention_bwd"] == 1
    for g_, w_ in zip((qg.grad, kg.grad, vg.grad), want):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("d", [40, 64, 80])
@pytest.mark.parametrize("s", [77, 333, 1001])
def test_attention_backward_on_the_forward_logsumexp(dev, s, d):
    """B1b at odd S on the logsumexp B1's forward keeps: within
    chip_smoke.BWD_B1_RTOL of the plain backward, bit for bit the call
    that recomputes the logsumexp, two calls equal; the kept logsumexp
    within chip_smoke.LSE_ATOL of ``attention_lse_ref``."""
    import chip_smoke
    q, k, v, do = (torch.randn(2, s, 3, d, device=dev, generator=_gen(i))
                   .to(torch.bfloat16) for i in range(4))
    scale = d ** -0.5
    o, lse = attention._self_attention_cuda(q, k, v, scale, with_lse=True)
    assert lse.shape == (2, 3, s) and lse.dtype == torch.float32
    assert (lse - attention.attention_lse_ref(q, k, scale)).abs().max() \
        <= chip_smoke.LSE_ATOL
    got = attention._attention_bwd_cuda(q, k, v, o, do, scale, lse)
    again = attention._attention_bwd_cuda(q, k, v, o, do, scale, lse)
    recomputed = attention._attention_bwd_cuda(q, k, v, o, do, scale)
    want = attention.attention_bwd_ref(*(t.float() for t in (q, k, v, o, do)),
                                       scale)
    for x, y, z, w in zip(got, again, recomputed, want):
        assert torch.equal(x, y) and torch.equal(x, z)
        assert _rel(x, w) <= chip_smoke.BWD_B1_RTOL


@pytest.mark.parametrize("s,d", [(1024, 40), (600, 80), (4429, 64)])
def test_forward_that_keeps_the_logsumexp_is_the_no_grad_one(dev, s, d):
    """Under autograd B1's forward keeps each row's logsumexp for B1b: its
    output is the no-grad output bit for bit, each counts one launch of
    B1, and the logsumexp it saved is the plain one."""
    import chip_smoke
    q, k, v = (torch.randn(1, s, 2, d, device=dev, generator=_gen(i))
               .to(torch.bfloat16) for i in range(3))
    ops.reset_launch_counts()
    with torch.no_grad():
        want = attention.self_attention(q, k, v, d ** -0.5)
    assert ops.launch_counts()["attention"] == 1
    qg = q.clone().requires_grad_()
    out = attention.self_attention(qg, k, v, d ** -0.5)
    assert ops.launch_counts()["attention"] == 2
    assert torch.equal(out.detach(), want)
    lse = out.grad_fn.saved_tensors[4]
    assert (lse - attention.attention_lse_ref(q, k, d ** -0.5)).abs().max() \
        <= chip_smoke.LSE_ATOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,c", [(2, 1000, 200), (1, 4096, 640)])
def test_gn_stats_backward_matches_plain(dev, dtype, b, s, c):
    """B5b against its plain backward: one rounding of the same f32 value
    in bf16 (an ulp of the largest |dx|), 1e-6 relative in f32; through
    GNStats under autograd the same bits."""
    x = (torch.randn(b, s, c, device=dev, generator=_gen(1)) * 2 + 1).to(
        dtype)
    ds1, ds2 = (torch.randn(b, c, device=dev, generator=_gen(i))
                for i in (2, 3))
    got = group_norm._gn_stats_bwd_cuda(x, ds1, ds2)
    want = group_norm.gn_stats_bwd_ref(x.float(), ds1, ds2)
    top = want.abs().max().item()
    tol = (2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16
           else 1e-6 * top)
    assert got.dtype == dtype and (got.float() - want).abs().max() <= tol
    xg = x.clone().requires_grad_()
    s1, s2 = group_norm.gn_stats(xg)
    torch.autograd.backward((s1, s2), (ds1, ds2))
    assert torch.equal(xg.grad, got)


@pytest.mark.parametrize("b,h2,w2,ci,co", [
    (1, 16, 16, 128, 128), (2, 8, 16, 64, 192), (1, 32, 32, 640, 640),
    (1, 5, 16, 128, 64)])
def test_conv_up_backward_matches_plain(dev, b, h2, w2, ci, co):
    """B3b-dx and B3b-dw against the plain backward in f32 on the same
    bf16 values (chip_smoke's bounds), pixel counts that are not a tile's;
    two calls give the same bits; through ConvUp under autograd the same
    gradients."""
    import chip_smoke
    hh = torch.randn(b, h2, w2, ci, device=dev, generator=_gen(1)).to(
        torch.bfloat16)
    w = (torch.randn(co, ci, 3, 3, device=dev, generator=_gen(2))
         / (9 * ci) ** 0.5).to(torch.bfloat16)
    bias = torch.randn(co, device=dev, generator=_gen(3)).to(torch.bfloat16)
    dy = torch.randn(b, 2 * h2, 2 * w2, co, device=dev, generator=_gen(4)).to(
        torch.bfloat16)
    dh = conv3x3._conv3x3_up_bwd_dx_cuda(dy, w, hh.shape)
    dw, db = conv3x3._conv3x3_up_bwd_dw_cuda(dy, hh)
    dw2, db2 = conv3x3._conv3x3_up_bwd_dw_cuda(dy, hh)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(dh, conv3x3._conv3x3_up_bwd_dx_cuda(dy, w, hh.shape))
    want = conv3x3.conv3x3_up_bwd_ref(hh.float(), w.float(), dy.float())
    assert _rel(dh, want[0]) <= chip_smoke.BWD_DX_RTOL
    assert _rel(dw, want[1]) <= chip_smoke.BWD_DW_RTOL
    assert _rel(db, want[2]) <= chip_smoke.BWD_DW_RTOL
    hg, wg, bg = (t.clone().requires_grad_() for t in (hh, w, bias))
    ops.reset_launch_counts()
    y = conv3x3.conv3x3_up(hg, wg, bg)
    assert torch.equal(y.detach(), conv3x3.conv3x3_up(hh, w, bias))
    y.backward(dy)
    assert torch.equal(hg.grad, dh)
    assert torch.equal(wg.grad, dw.to(torch.bfloat16))
    assert torch.equal(bg.grad, db.to(torch.bfloat16))
    counts = ops.backward_launch_counts()
    assert counts["conv3x3_up_bwd_dx"] == 1
    assert counts["conv3x3_up_bwd_dw"] == 1


def test_conv_up_backward_makes_no_host_sync(dev):
    """ConvUp's forward and backward (B3, the weight fold, B3b-dx and
    B3b-dw) under ``torch.cuda.set_sync_debug_mode("error")``: nothing on
    the path waits for the stream (the fold table is made on the card,
    not copied from the host)."""
    hh, w, bias = (torch.randn(shape, device=dev, generator=_gen(i)).to(
        torch.bfloat16).requires_grad_() for i, shape in enumerate(
        ((1, 32, 32, 640), (640, 640, 3, 3), (640,))))
    dy = torch.randn(1, 64, 64, 640, device=dev, generator=_gen(5)).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = conv3x3.conv3x3_up(hh, w, bias)
        y.backward(dy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t.grad).all() for t in (hh, w, bias))


def test_conv_up_backward_dx_pads_co_32(dev):
    """B3b-dx at Co % 64 == 32 (zero channels appended to dy and W4) and
    at Co % 128 == 64 for B3b-dw, against the plain backward."""
    import chip_smoke
    b, h2, w2, ci, co = 1, 6, 20, 64, 96
    hh = torch.randn(b, h2, w2, ci, device=dev, generator=_gen(1)).to(
        torch.bfloat16)
    w = (torch.randn(co, ci, 3, 3, device=dev, generator=_gen(2))
         / (9 * ci) ** 0.5).to(torch.bfloat16)
    dy = torch.randn(b, 2 * h2, 2 * w2, co, device=dev, generator=_gen(4)).to(
        torch.bfloat16)
    dh = conv3x3._conv3x3_up_bwd_dx_cuda(dy, w, hh.shape)
    want = conv3x3.conv3x3_up_bwd_ref(hh.float(), w.float(), dy.float())
    assert _rel(dh, want[0]) <= chip_smoke.BWD_DX_RTOL
    with pytest.raises(ValueError, match="Co % 64 == 0"):
        conv3x3._conv3x3_up_bwd_dw_cuda(dy, hh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("co,ci", [(640, 640), (96, 64), (40, 72)])
def test_bwd_dx_fold_pass_matches_plain_bits(dev, dtype, co, ci):
    """B3b-dx's fold pass against ``bwd_dx_weights`` (the same sums as
    torch ops on the card), bit for bit, at channel counts that are not a
    block's multiple."""
    w = (torch.randn(co, ci, 3, 3, device=dev, generator=_gen(7))
         / 8).to(dtype)
    got = conv3x3._bwd_dx_fold_cuda(w)
    want = conv3x3.bwd_dx_weights(w)
    assert got.shape == (16, ci, co)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("name", [
    "attention_f32", "attention_i8", "attention_nt", "attention_bshd",
    "repack_to_heads", "repack_from_heads", "rbf", "conv3x3",
    "conv3x3_up_interleave", "gn_fused"])
def test_kernels_without_backward_raise_under_autograd(dev, name,
                                                       monkeypatch):
    """Each kernel without a backward raises under autograd, through the
    entry the port calls it from; under no_grad the same call runs."""
    def x(shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=dev, generator=_gen(0)).to(
            dtype).requires_grad_()

    calls = {
        "attention_f32": lambda: attention.self_attention(
            *(x((1, 512, 2, 40), torch.float32) for _ in range(3)), 0.1),
        "attention_i8": lambda: attention.self_attention(
            *(x((1, 512, 2, 40)) for _ in range(3)), 0.1),
        "attention_nt": lambda: attention.attention_nt(
            *(x((2, 512, 40)) for _ in range(3)), 0.1),
        "attention_bshd": lambda: attention.attention_bshd(
            *(x((1, 512, 2, 40)) for _ in range(3)), 0.1),
        "repack_to_heads": lambda: attention.repack_to_heads(
            x((1, 512, 80)), 2),
        "repack_from_heads": lambda: attention.repack_from_heads(
            x((1, 2, 512, 40))),
        "rbf": lambda: repellency_kernels.rbf_negative_score(
            x((2, 128), torch.float32), x((5, 128), torch.float32), 3.0),
        "conv3x3": lambda: conv3x3.conv3x3(x((1, 8, 16, 128)),
                                           x((128, 128, 3, 3))),
        "conv3x3_up_interleave": lambda: conv3x3.conv3x3_up(
            x((1, 16, 16, 128)), x((128, 128, 3, 3)), form="interleave"),
        "gn_fused": lambda: group_norm.group_norm_fused(
            x((1, 4096, 320)), x((320,), torch.float32),
            x((320,), torch.float32), 32, act="silu"),
    }
    if name == "attention_i8":
        monkeypatch.setenv("SDT_INT8_ATTN", "1")
    with pytest.raises(RuntimeError, match="no backward yet"):
        calls[name]()
    with torch.no_grad():
        out = calls[name]()
    torch.cuda.synchronize()
    assert out is not None


def test_tiny_f32_training_step_on_gpu_matches_the_cpu(dev):
    """One ESD step of a tiny f32 UNet (no custom kernel at 8x8 latents:
    cuBLAS, cuDNN and the plain forms, TF32 off): the loss and every
    gradient within 2e-3 of the CPU's (relative to each tensor's largest),
    the AdamW step's weights within 2e-3."""
    from safe_denoiser_tpu_torch.models import (UNet2DConditionModel,
                                                UNetConfig)
    from safe_denoiser_tpu_torch.training import (ESDConfig, esd_loss,
                                                  esd_param_mask,
                                                  make_optimizer)
    from safe_denoiser_tpu_torch.training.esd import module_apply_fn

    torch.manual_seed(0)
    cpu = UNet2DConditionModel(UNetConfig(
        sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
        cross_attention_dim=32, num_attention_heads=2, norm_num_groups=8))
    gpu = UNet2DConditionModel(cpu.config).to(dev)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    x_t = torch.randn(2, 4, 8, 8, generator=g)
    ctx_c, ctx_u = (torch.randn(2, 7, 32, generator=g) for _ in range(2))
    t = torch.tensor([900, 100])
    out = {}
    for where, module in (("cpu", cpu), ("cuda", gpu)):
        d = torch.device(where)
        params = {n: p.detach().clone() for n, p in module.named_parameters()}
        frozen = {n: p.clone() for n, p in params.items()}
        opt = make_optimizer(ESDConfig(learning_rate=1e-4), params,
                             esd_param_mask(params, "noxattn"))
        loss = esd_loss(module_apply_fn(module, torch.float32), params,
                        frozen, x_t.to(d), t.to(d), ctx_c.to(d), ctx_u.to(d))
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in params.items()
                 if p.grad is not None}
        opt.step()
        out[where] = (loss.item(), grads,
                      {n: p.detach().cpu() for n, p in params.items()})
    assert abs(out["cpu"][0] - out["cuda"][0]) <= 2e-3 * abs(out["cpu"][0])
    assert set(out["cpu"][1]) == set(out["cuda"][1])
    for n, g_ in out["cpu"][1].items():
        assert _rel(out["cuda"][1][n], g_) <= 2e-3, n
    for n, p in out["cpu"][2].items():
        assert (out["cuda"][2][n] - p).abs().max() <= 2e-3, n


# ------------------------------------------------------------------ adaln
ADALN_MODES = ("norm", "residual+norm", "residual")


def _adaln_inputs(b, s, d, dtype, seed, mode):
    """x ~ N(0.5, 2^2) and delta [b, s, d], and the keywords of ``mode``
    from the chunks of a [b, 6d] modulation row (batch stride 6d, as the
    MMDiT's ``mod.chunk(6, -1)``)."""
    gen = _gen(seed)
    x = (torch.randn(b, s, d, device="cuda", generator=gen) * 2 + 0.5
         ).to(dtype)
    delta = torch.randn(b, s, d, device="cuda", generator=gen).to(dtype)
    mod = (torch.randn(b, 6 * d, device="cuda", generator=gen) * 0.5
           ).to(dtype)
    shift, scale, gate = mod.chunk(6, -1)[:3]
    kw = {"norm": dict(scale=scale, shift=shift),
          "residual+norm": dict(scale=scale, shift=shift, gate=gate,
                                delta=delta),
          "residual": dict(gate=gate, delta=delta)}[mode]
    return x, kw


def _adaln_check(got, want, mode):
    """x' equal bit for bit (the same f32 product and sum, rounded once);
    h within one ulp of its own magnitude (the row's sums in another
    order, rsqrtf: the same f32 value to a few ulps may round to the
    neighbouring value), and 2^-20 of max|h| where a shift that cancels
    the product leaves h far smaller than the terms whose f32 ulps it
    carries."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (2 if mode == "residual+norm" else 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
    if mode != "norm":
        assert torch.equal(got[0], want[0])
    if mode != "residual":
        g, w = got[-1].double(), want[-1].double()
        bits = {torch.bfloat16: 7, torch.float16: 10,
                torch.float32: 23}[got[-1].dtype]
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -14))) - bits)
        tol = ulp + 2.0 ** -20 * w.abs().max()
        assert ((g - w).abs() <= tol).all(), (g - w).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("mode", ADALN_MODES)
@pytest.mark.parametrize("s", [4096, 333])
def test_adaln_kernel_matches_plain(dev, s, mode, dtype):
    """SD3-medium's rows: the image stream [2, 4096, 1536] and the context
    [2, 333, 1536] (CFG's batch of 2), each mode, against adaln_ref."""
    x, kw = _adaln_inputs(2, s, 1536, dtype, 31, mode)
    ops.reset_launch_counts()
    got = adaln.adaln(x, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["adaln"] == 1
    _adaln_check(got, adaln.adaln_ref(x, **kw), mode)


@pytest.mark.parametrize("d", [8, 520, 2432, 3072])
@pytest.mark.parametrize("mode", ADALN_MODES)
def test_adaln_kernel_at_other_widths(dev, d, mode):
    """Widths whose vectors do not fill a lane's (520: 65 vectors), SD3.5-
    large's 2432 and the widest the kernel takes; 7 rows, which leave a
    block's last warps idle."""
    x, kw = _adaln_inputs(1, 7, d, torch.bfloat16, 32, mode)
    _adaln_check(adaln.adaln(x, **kw), adaln.adaln_ref(x, **kw), mode)


def test_adaln_kernel_on_a_slot_slice(dev):
    """A sequence-parallel slot's token slice of the stream and of delta
    (strided rows), with the modulations of a [B, 2D] row."""
    x, kw = _adaln_inputs(2, 600, 1536, torch.bfloat16, 33,
                          "residual+norm")
    x, delta = x[:, 100:400], kw["delta"][:, 200:500]
    mod = torch.randn(2, 2 * 1536, device=dev).bfloat16()
    kw = dict(scale=mod[:, :1536], shift=mod[:, 1536:], gate=kw["gate"],
              delta=delta)
    assert adaln.fits(x, **kw)
    _adaln_check(adaln.adaln(x, **kw), adaln.adaln_ref(x, **kw),
                 "residual+norm")


def test_adaln_kernel_under_a_cuda_graph(dev):
    """The three modes captured into one CUDA graph, the inputs changed in
    place, replayed: each output that of the new inputs; the wrapper ran
    (and counted) once per mode, at capture."""
    ins = [_adaln_inputs(2, 4096, 1536, torch.bfloat16, 34, m)
           for m in ADALN_MODES]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x, kw in ins:
            adaln.adaln(x, **kw)
    torch.cuda.current_stream().wait_stream(side)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [adaln.adaln(x, **kw) for x, kw in ins]
    assert ops.launch_counts()["adaln"] == 3
    gen = _gen(35)
    for x, kw in ins:
        for t in (x, *kw.values()):
            t.copy_(torch.randn(t.shape, device=dev, generator=gen))
    graph.replay()
    torch.cuda.synchronize()
    for (x, kw), out, mode in zip(ins, outs, ADALN_MODES):
        _adaln_check(out, adaln.adaln_ref(x, **kw), mode)
    assert ops.launch_counts()["adaln"] == 3


def test_adaln_wrapper_rejects_what_the_kernel_does_not_take(dev):
    """A CUDA tensor the kernel does not take raises, with autograd too:
    no plain form on the GPU."""
    x, kw = _adaln_inputs(2, 64, 256, torch.bfloat16, 36, "norm")
    ops.reset_launch_counts()
    for bad_x, bad_kw in (
            (x.double(), {k: v.double() for k, v in kw.items()}),
            (x.transpose(1, 2).contiguous().transpose(1, 2), kw),
            (x[..., :252], {k: v[:, :252] for k, v in kw.items()}),
            (x, dict(kw, scale=kw["scale"].float())),
            (x, dict(kw, scale=torch.cat([kw["scale"]] * 2))),
            (x.transpose(1, 2).contiguous().transpose(1, 2)
             .requires_grad_(), kw)):
        assert not adaln.fits(bad_x, **bad_kw)
        with pytest.raises(ValueError):
            adaln.adaln(bad_x, **bad_kw)
    assert ops.launch_counts()["adaln"] == 0


def test_adaln_kernel_broadcasts_a_modulation_row(dev):
    """[1, D] modulations read by every batch row (batch stride 0)."""
    x, kw = _adaln_inputs(3, 50, 1536, torch.bfloat16, 38, "residual+norm")
    kw = {k: (v[:1] if v.dim() == 2 else v) for k, v in kw.items()}
    _adaln_check(adaln.adaln(x, **kw), adaln.adaln_ref(x, **kw),
                 "residual+norm")


@pytest.mark.parametrize("mode", ADALN_MODES)
def test_adaln_kernel_under_autograd(dev, mode):
    """With gradients wanted the forward still launches the kernel once,
    its outputs as without; the backward's gradients are autograd's through
    adaln_ref on the same inputs, bit for bit (the backward is that plain
    code)."""
    x, kw = _adaln_inputs(2, 333, 1536, torch.bfloat16, 39, mode)
    leaves = [x.requires_grad_(), *(v.requires_grad_() for v in kw.values())]
    ops.reset_launch_counts()
    got = adaln.adaln(x, **kw)
    assert ops.launch_counts()["adaln"] == 1
    with torch.no_grad():
        _adaln_check(got, adaln.adaln(x, **kw), mode)
    want = adaln.adaln_ref(x, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    gen = _gen(40)
    ws = [torch.randn(o.shape, device=dev, generator=gen) for o in got]
    g_got = torch.autograd.grad(
        sum((o.float() * w).sum() for o, w in zip(got, ws)), leaves)
    g_want = torch.autograd.grad(
        sum((o.float() * w).sum() for o, w in zip(want, ws)), leaves)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)


def _adaln_composition(x, scale=None, shift=None, gate=None, delta=None):
    """The eager composition the MMDiT ran before adaln: an f32 LayerNorm,
    then the modulation and the gated residual in the stream's dtype."""
    if delta is not None:
        x = x + gate[:, None] * delta
        if scale is None:
            return x
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    ln = ((xf - mean) * torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True)
                                    + adaln.EPS)).to(x.dtype)
    h = ln * (1 + scale[:, None]) + shift[:, None]
    return h if delta is None else (x, h)


@pytest.mark.parametrize("dtype,grad", [(torch.bfloat16, False),
                                        (torch.float32, False),
                                        (torch.bfloat16, True)])
def test_mmdit_sends_its_sites_to_adaln(dev, monkeypatch, dtype, grad):
    """A tiny MMDiT (2 blocks) on the GPU: 6 * 2 - 1 launches, under
    autograd too, and its output (and its parameters' gradients) within
    round-off of the eager composition's on the GPU."""
    from safe_denoiser_tpu_torch.models import mmdit

    torch.manual_seed(0)
    m = mmdit.MMDiT(mmdit.MMDiTConfig(
        sample_size=16, patch_size=2, in_channels=4, out_channels=4,
        num_layers=2, num_heads=2, head_dim=16, joint_attention_dim=24,
        caption_projection_dim=32, pooled_projection_dim=20,
        pos_embed_max_size=12))
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    m = m.to(dev, dtype)
    gen = _gen(37)
    args = (torch.randn(2, 4, 8, 8, device=dev, generator=gen),
            torch.tensor([981.0, 311.5], device=dev),
            torch.randn(2, 5, 24, device=dev, generator=gen),
            torch.randn(2, 20, device=dev, generator=gen))

    def run():
        m.zero_grad()
        out = m(*args)
        if grad:
            out.square().mean().backward()
        return out.detach(), [p.grad for p in m.parameters()]

    ops.reset_launch_counts()
    with torch.set_grad_enabled(grad):
        got, g_got = run()
        assert ops.launch_counts()["adaln"] == 11
        monkeypatch.setattr(adaln, "adaln", _adaln_composition)
        want, g_want = run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["adaln"] == 11
    bound = 2e-2 if dtype == torch.bfloat16 else 1e-5
    err = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert err < bound, err
    if grad:
        assert [a is None for a in g_got] == [b is None for b in g_want]
        a, b = (torch.cat([g.float().flatten() for g in gs if g is not None])
                for gs in (g_got, g_want))
        err = ((a - b).norm() / b.norm()).item()
        assert err < 5e-2, err


# the last test: a failed capture leaves the default CUDA generator in a
# state that later initializers on the device trip over
def test_graph_capture_failure_raises(dev):
    """A loop that syncs with the host cannot be captured: the slot
    raises, and runs nothing eagerly in its place."""
    from safe_denoiser_tpu_torch.pipeline import graph

    calls = []

    def loop(bufs, steps=None):
        calls.append(steps)
        x = bufs["latents"] * 2
        if steps is None and x.sum().item() > 1e30:  # a host sync
            x = x + 1
        return x, torch.zeros(1, dtype=torch.bool, device=x.device)

    program = graph.Program(("sync",), loop, lambda x: x, 0,
                            np.zeros(1, np.int64))
    bufs = {"latents": torch.ones(4, device=dev)}
    with pytest.raises(RuntimeError):
        graph.GraphSlot().run(program, bufs)
    assert calls == [(0,), None]
    torch.cuda.synchronize()
