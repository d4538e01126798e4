"""FLUX.1 on the GPU: the fused qk-RMSNorm + rotary kernel (``ops.qk_rope``)
against its plain version at FLUX.1-dev's double- and single-block shapes
[1, 4608, 24, 128], at ragged sizes, head dims, f32 and strided rows, under
a CUDA graph, and the inputs it refuses; B1 at FLUX's [1, 4608, 24, 128]
against ``attention_ref``; the graphed FLUX loop against the eager body on
the same buffers, bit for bit, with its launch counts.

Every test is marked ``cuda`` and skips where no GPU is visible. On a GPU
machine (which need not have JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_flux_cuda.py
"""

import pytest
import torch

from safe_denoiser_tpu_torch import ops
from safe_denoiser_tpu_torch.models.flux import position_ids, rope_tables
from safe_denoiser_tpu_torch.ops import attention, qk_rope

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _tables(txt, gh, gw, d):
    """FLUX's rotary tables of [txt ; gh x gw] on the GPU, the axes split
    as FLUX.1's (16, 56, 56) scaled to head dim d."""
    axes = (d // 8, 7 * d // 16, 7 * d // 16)
    cos, sin = rope_tables(position_ids(txt, gh, gw), axes)
    return (torch.from_numpy(cos).cuda(), torch.from_numpy(sin).cuda())


def _segment(b, s, h, d, dtype, gen, fused=False):
    """(q, k, v, wq, wk) of one stream: [b, s, h, d] views of projections
    [b, s, h*d] (``fused``: column slices of one [b, s, 3*h*d] projection,
    rows 3*h*d apart), values ~ N(0, 2^2) + 0.3, weights 1 + N(0, 0.1^2)."""
    width = h * d
    if fused:
        big = (torch.randn(b, s, 3 * width, device="cuda", generator=gen) * 2
               + 0.3).to(dtype)
        parts = big.split(width, -1)
    else:
        parts = [(torch.randn(b, s, width, device="cuda", generator=gen) * 2
                  + 0.3).to(dtype) for _ in range(3)]
    q, k, v = (p.unflatten(-1, (h, d)) for p in parts)
    wq, wk = ((1 + 0.1 * torch.randn(d, device="cuda", generator=gen))
              .to(dtype) for _ in range(2))
    return q, k, v, wq, wk


def _check(got, want, copies_v):
    """q and k within one ulp of their magnitude (the sum of squares in
    another order and rsqrtf move the f32 value by a few ulps, which may
    round to the neighbouring one) and 2^-20 of max|out| where the rotary's
    two products cancel; v (the joined copy) bit for bit."""
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        g, w = g.double(), w.double()
        bits = 7 if got[0].dtype == torch.bfloat16 else 23
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -14))) - bits)
        tol = ulp + 2.0 ** -20 * w.abs().max()
        assert ((g - w).abs() <= tol).all(), (g - w).abs().max().item()
    if copies_v:
        assert got[2].is_contiguous() and torch.equal(got[2], want[2])
    else:
        assert got[2] is want[2]


@pytest.mark.parametrize("block", ["double", "single"])
def test_qk_rope_kernel_matches_plain_at_flux_dev(dev, block):
    """FLUX.1-dev at 1024^2: the double block's [text 512 ; image 4096]
    (v joined too) and the single block's one stream of 4608, 24 heads of
    128, bf16."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    lengths = (512, 4096) if block == "double" else (4608,)
    segs = [_segment(1, s, 24, 128, torch.bfloat16, gen) for s in lengths]
    cos, sin = _tables(512, 64, 64, 128)
    ops.reset_launch_counts()
    got = qk_rope.qk_rope(segs, cos, sin)
    torch.cuda.synchronize()
    assert ops.launch_counts()["qk_rope"] == 1
    assert got[0].shape == (1, 4608, 24, 128)
    _check(got, qk_rope.qk_rope_ref(segs, cos, sin), block == "double")


@pytest.mark.parametrize("d", qk_rope.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths,fused", [((7, 33), False), ((5,), True),
                                           ((1, 250), True)])
def test_qk_rope_kernel_at_ragged_sizes(dev, d, dtype, lengths, fused):
    """Two batch rows, 3 heads, segments of odd lengths (a block's last
    groups idle), every head dim the kernel takes, f32 too, and q/k/v as
    column slices of one fused projection (rows 3*H*D apart)."""
    gen = torch.Generator(device="cuda").manual_seed(42 + d)
    segs = [_segment(2, s, 3, d, dtype, gen, fused) for s in lengths]
    txt = lengths[0] if len(lengths) == 2 else 0
    cos, sin = _tables(txt, 1, sum(lengths) - txt, d)
    assert qk_rope.fits(segs, cos, sin)
    _check(qk_rope.qk_rope(segs, cos, sin), qk_rope.qk_rope_ref(
        segs, cos, sin), len(lengths) == 2)


def test_qk_rope_kernel_under_a_cuda_graph(dev):
    """Captured once, the inputs changed in place, replayed: the outputs
    are the new inputs'; the wrapper ran (and counted) once, at capture."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    segs = [_segment(1, s, 4, 128, torch.bfloat16, gen) for s in (16, 240)]
    cos, sin = _tables(16, 16, 15, 128)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qk_rope.qk_rope(segs, cos, sin)
    torch.cuda.current_stream().wait_stream(side)
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qk_rope.qk_rope(segs, cos, sin)
    assert ops.launch_counts()["qk_rope"] == 1
    for seg in segs:
        for t in seg[:3]:
            t.copy_(torch.randn(t.shape, device=dev, generator=gen))
    graph.replay()
    torch.cuda.synchronize()
    _check(out, qk_rope.qk_rope_ref(segs, cos, sin), True)


def test_qk_rope_wrapper_rejects_what_the_kernel_does_not_take(dev):
    """A CUDA tensor the kernel does not take raises, under autograd too:
    no plain form on the GPU."""
    gen = torch.Generator(device="cuda").manual_seed(44)
    seg = _segment(1, 64, 2, 64, torch.bfloat16, gen)
    cos, sin = _tables(0, 8, 8, 64)
    q, k, v, wq, wk = seg
    ops.reset_launch_counts()
    for bad, tables in (
            ([tuple(t[..., :48] for t in (q, k, v)) + (wq[:48], wk[:48])],
             (cos[:, :48].contiguous(), sin[:, :48].contiguous())),
            ([(q.half(), k.half(), v.half(), wq.half(), wk.half())],
             (cos, sin)),
            ([(q, k, v, wq.float(), wk)], (cos, sin)),
            ([(q, k, v, wq, wk)], (cos.bfloat16(), sin)),
            ([(q, k, v, wq, wk)], (cos[:32], sin[:32])),
            ([(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, wq,
               wk)], (cos, sin)),
            ([seg] * 3, (torch.cat([cos] * 3), torch.cat([sin] * 3)))):
        assert not qk_rope.fits(bad, *tables)
        with pytest.raises(ValueError):
            qk_rope.qk_rope(bad, *tables)
    with pytest.raises(RuntimeError, match="no backward"):
        qk_rope.qk_rope([(q.clone().requires_grad_(), k, v, wq, wk)], cos,
                        sin)
    assert ops.launch_counts()["qk_rope"] == 0


def test_attention_kernel_at_flux_dev(dev):
    """B1 at FLUX.1-dev's joint attention [1, 4608, 24, 128] (its D = 128
    instance) against ``attention_ref`` in f32, within BF16_ATOL."""
    gen = torch.Generator(device="cuda").manual_seed(45)
    q, k, v = (torch.randn(1, 4608, 24, 128, device=dev, generator=gen)
               .bfloat16() for _ in range(3))
    ops.reset_launch_counts()
    got = attention.self_attention(q, k, v, 128 ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["attention"] == 1
    want = attention.attention_ref(q.float(), k.float(), v.float(),
                                   128 ** -0.5)
    err = (got.float() - want).abs().max().item()
    assert err <= attention.BF16_ATOL, err


@pytest.fixture
def flux_pipe(dev):
    """A FLUX pipeline at head dim 128 on the GPU in bf16: 2 double and 2
    single blocks of 2 heads, a two-level VAE, 128^2 images (64 x 64
    latents: 1024 image tokens and 16 text tokens, so the attention is
    B1's), kernel_fast in [1000, 500]."""
    from safe_denoiser_tpu_torch.models import (
        AutoencoderKL, CLIPTextConfig, CLIPTextModel, FluxConfig,
        FluxTransformer, T5Config, T5Encoder, VAEConfig)
    from safe_denoiser_tpu_torch.pipeline import RepellencyWindow
    from safe_denoiser_tpu_torch.pipeline.diffusion_flux import \
        SafeFluxPipeline
    from safe_denoiser_tpu_torch.repellency import KernelFastRepellency
    from safe_denoiser_tpu_torch.schedulers import (FlowMatchDynamicConfig,
                                                    FlowMatchEulerScheduler)
    from safe_denoiser_tpu_torch.text import CLIPTokenizer

    torch.manual_seed(0)
    tok = CLIPTokenizer([], None)
    tf = FluxTransformer(FluxConfig(
        in_channels=64, num_layers=2, num_single_layers=2, num_heads=2,
        head_dim=128, joint_attention_dim=64, pooled_projection_dim=32))
    for p in tf.parameters():
        p.data.mul_(0.3)
    vae = AutoencoderKL(VAEConfig(
        latent_channels=16, block_out_channels=(128, 128),
        layers_per_block=1, norm_num_groups=32, scaling_factor=0.3611,
        shift_factor=0.1159, use_quant_conv=False,
        use_post_quant_conv=False))
    clip = CLIPTextModel(CLIPTextConfig(
        vocab_size=600, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, projection_dim=32,
        eos_token_id=tok.eos_token_id), with_projection=False)
    t5 = T5Encoder(T5Config(vocab_size=600, d_model=64, d_kv=16, d_ff=128,
                            num_layers=2, num_heads=4))
    pipe = SafeFluxPipeline(
        tf.bfloat16(), vae.bfloat16(), clip, t5.bfloat16(), tok, tok,
        FlowMatchEulerScheduler(FlowMatchDynamicConfig()), device=dev,
        max_sequence_length=16)
    proc = KernelFastRepellency(
        ref_data=torch.randn(4, 16, 64, 64, device=dev), embed_fn=lambda x: x,
        sigma=1.0, scale=0.03, normalize_x=True, device=dev)
    kw = dict(num_inference_steps=4, height=128, width=128,
              repellency_processor=proc,
              window=RepellencyWindow(1000.0, 500.0))
    return pipe, kw


def test_flux_graph_equals_eager_bit_for_bit(flux_pipe):
    """The graphed FLUX loop and decode against the eager body on the same
    buffers: equal bit for bit; the replay's launch counts equal the eager
    run's: qk_rope once a block a step, B1 as often and once more in the
    decoder's mid-block (one 128-wide head over 4096 tokens), adaln 6 a
    double block, 2 a single block and 1 a call, B2 on the steps inside
    the window."""
    from safe_denoiser_tpu_torch.pipeline import graph

    pipe, kw = flux_pipe
    program, bufs = pipe._prepare_batch(["a cat", "a dog"], [3, 4],
                                        [3.5, 2.0], **kw)
    ops.reset_launch_counts()
    pending = pipe._launch(program, bufs)
    pending.fetch()
    graphed = ops.launch_counts()
    ops.reset_launch_counts()
    lat, applied, image = graph._run_eager(program, bufs)
    torch.cuda.synchronize()
    assert ops.launch_counts() == graphed
    in_window = sum(500.0 <= float(t) <= 1000.0 for t in program.timesteps)
    assert graphed["qk_rope"] == graphed["attention"] - 1 == 4 * 4
    assert graphed["adaln"] == (6 * 2 + 2 * 2 + 1) * 4
    assert graphed["rbf"] == in_window > 0
    assert "capture" in pending.stage_ms
    assert torch.equal(pending.latents, lat)
    assert torch.equal(pending.applied, applied)
    assert torch.equal(pending.image, image)
    assert torch.isfinite(lat).all()
