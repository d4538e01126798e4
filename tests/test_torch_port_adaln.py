"""The MMDiT's token-major stream and its one-pass norm and residual sites
(``ops/adaln.py``), on the CPU: the kernel's plain version against the
eager composition the MMDiT ran before it (an f32 LayerNorm, then the
modulation and the gated residual in the stream's dtype), the test of which
tensors the kernel takes, ``AdaLN``'s gradient, the sites the MMDiT sends
to ``adaln``, the MMDiT's gradient, and the stream's layout and copies.

The kernel itself runs only on a GPU (``tests/test_torch_port_cuda.py``);
on the CPU ``adaln.adaln`` takes ``adaln_ref``.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from safe_denoiser_tpu_torch.models import mmdit as t_mmdit
from safe_denoiser_tpu_torch.ops import adaln

B, S, D = 2, 5, 64
MODES = ("norm", "residual+norm", "residual")
TINY = dict(sample_size=16, patch_size=2, in_channels=4, out_channels=4,
            num_heads=2, head_dim=16, joint_attention_dim=24,
            caption_projection_dim=32, pooled_projection_dim=20,
            pos_embed_max_size=12)


def _ulp(t: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at each element's magnitude (its normal range)."""
    bits = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[dtype]
    m = t.abs().double().clamp_min(torch.finfo(dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - bits)


def _inputs(dtype, seed=0):
    """x, delta [B, S, D] and the six [B, D] chunks of a modulation row
    (views with batch stride 6D, as ``mod.chunk(6, -1)`` gives)."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, S, D, generator=g) * 2 + 0.5).to(dtype)
    delta = torch.randn(B, S, D, generator=g).to(dtype)
    mod = (torch.randn(B, 6 * D, generator=g) * 0.5).to(dtype)
    chunks = mod.chunk(6, -1)
    assert chunks[1].stride() == (6 * D, 1)
    return x, delta, chunks


def _args(mode, chunks, delta):
    shift, scale, gate = chunks[:3]
    return {"norm": dict(scale=scale, shift=shift),
            "residual+norm": dict(scale=scale, shift=shift, gate=gate,
                                  delta=delta),
            "residual": dict(gate=gate, delta=delta)}[mode]


def _layer_norm_fp32(x, eps=adaln.EPS):
    """LayerNorm without affine: f32 statistics, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _composition(x, scale=None, shift=None, gate=None, delta=None,
                 eps=adaln.EPS):
    """The eager composition of each mode, as the MMDiT ran it before."""
    if delta is not None:
        x = x + gate[:, None] * delta
        if scale is None:
            return x
    h = _layer_norm_fp32(x, eps) * (1 + scale[:, None]) + shift[:, None]
    return h if delta is None else (x, h)


def _exact(x, scale=None, shift=None, gate=None, delta=None):
    """The modes in f64, the residual rounded to x's dtype (what the stream
    carries), nothing else rounded."""
    if delta is not None:
        x = (x.double() + gate.double()[:, None] * delta.double()).to(x.dtype)
        if scale is None:
            return x
    xf = x.double()
    xc = xf - xf.mean(-1, keepdim=True)
    h = (xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + adaln.EPS)
         * (1 + scale.double()[:, None]) + shift.double()[:, None])
    return h if delta is None else (x, h)


def _outs(r):
    return r if isinstance(r, tuple) else (r,)


# --------------------------------------------- the plain version's numerics
@pytest.mark.parametrize("mode", MODES)
def test_adaln_ref_is_the_composition_in_f32(mode):
    x, delta, chunks = _inputs(torch.float32)
    kw = _args(mode, chunks, delta)
    for got, want in zip(_outs(adaln.adaln_ref(x, **kw)),
                         _outs(_composition(x, **kw))):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _half_ulps(*terms) -> torch.Tensor:
    """Half a bf16 ulp of each term, summed: the most that rounding each
    term to bf16 once can move a result."""
    return sum(0.5 * _ulp(t, torch.bfloat16) for t in terms)


@pytest.mark.parametrize("mode", MODES)
def test_adaln_ref_is_the_composition_in_bf16(mode):
    """The plain version rounds each output to bf16 once; the composition
    rounds the residual's product, LN(x), 1 + scale, the modulation's
    product and each sum. Each output differs from the composition's by at
    most half a bf16 ulp of every term either rounds (and a few f32 ulps of
    the f32 arithmetic): the same function, rounded at other places."""
    x, delta, chunks = _inputs(torch.bfloat16)
    kw = _args(mode, chunks, delta)
    got = _outs(adaln.adaln_ref(x, **kw))
    assert all(g.dtype == torch.bfloat16 for g in got)
    if mode != "norm":
        want = _composition(x, gate=kw["gate"], delta=kw["delta"])
        gd = kw["gate"][:, None] * kw["delta"]
        bound = _half_ulps(gd, want, got[0])
        assert ((got[0].double() - want.double()).abs() <= bound).all()
        x = got[0]   # h below: of the x' the plain version carries on
    if mode != "residual":
        want = _composition(x, kw["scale"], kw["shift"])
        y = _layer_norm_fp32(x)
        s1 = (1 + kw["scale"])[:, None]
        bound = (_half_ulps(y) * s1.double().abs()
                 + y.double().abs() * _half_ulps(s1) + _half_ulps(
                     y * s1, want, got[-1])
                 + 8 * _ulp(want.double(), torch.float32))
        assert ((got[-1].double() - want.double()).abs() <= bound).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", MODES)
def test_adaln_ref_rounds_each_output_once(mode, dtype):
    """Each output within half an ulp of the f64 value (and a few f32 ulps
    of slack for the f32 arithmetic before the one rounding)."""
    x, delta, chunks = _inputs(dtype, seed=3)
    kw = _args(mode, chunks, delta)
    for got, ex in zip(_outs(adaln.adaln_ref(x, **kw)),
                       _outs(_exact(x, **kw))):
        assert got.dtype == dtype
        slack = 0.5 * _ulp(ex, dtype) + 8 * _ulp(ex, torch.float32)
        assert ((got.double() - ex.double()).abs() <= slack).all()


def test_adaln_ref_residual_then_norm_is_the_two_modes_in_turn():
    x, delta, chunks = _inputs(torch.bfloat16, seed=5)
    shift, scale, gate = chunks[:3]
    xo, h = adaln.adaln_ref(x, scale, shift, gate, delta)
    assert torch.equal(xo, adaln.adaln_ref(x, gate=gate, delta=delta))
    assert torch.equal(h, adaln.adaln_ref(xo, scale, shift))


def test_adaln_refuses_a_partial_set_of_modulations():
    x, delta, chunks = _inputs(torch.bfloat16)
    with pytest.raises(ValueError):
        adaln.adaln(x, scale=chunks[1])
    with pytest.raises(ValueError):
        adaln.adaln(x, gate=chunks[2])


# ------------------------------------------------- which tensors it takes
def _case(name):
    x, delta, chunks = _inputs(torch.bfloat16)
    shift, scale, gate = chunks[:3]
    kw = dict(scale=scale, shift=shift, gate=gate, delta=delta)
    if name == "f16":
        x, delta, chunks = _inputs(torch.float16)
        kw = dict(scale=chunks[1], shift=chunks[0], gate=chunks[2],
                  delta=delta)
    elif name == "f32":
        x, delta, chunks = _inputs(torch.float32)
        kw = dict(scale=chunks[1], shift=chunks[0], gate=chunks[2],
                  delta=delta)
    elif name == "grad_x":
        x = x.clone().requires_grad_()
    elif name == "grad_mod":
        kw["scale"] = scale.clone().requires_grad_()
    elif name == "transposed":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "unaligned":
        x = torch.empty(B * S * D + 1, dtype=x.dtype)[1:].view(B, S, D
                                                              ).copy_(x)
    elif name == "odd_width":
        x, kw = x[..., :60], dict(scale=scale[:, :60], shift=shift[:, :60])
    elif name == "too_wide":
        w = adaln.MAX_D + 8
        x = torch.zeros(B, S, w, dtype=x.dtype)
        kw = dict(scale=torch.zeros(B, w, dtype=x.dtype),
                  shift=torch.zeros(B, w, dtype=x.dtype))
    elif name == "mixed_dtype":
        kw["gate"] = gate.float()
    elif name == "token_slice":
        # a sequence-parallel slot's slice of the stream: whole rows
        x, kw["delta"] = x[:, 1:4], delta[:, 1:4]
    elif name == "broadcast_mod":
        # one modulation row for every batch row: read with batch stride 0
        kw["scale"] = scale[:1]
    elif name == "other_batch_mod":
        kw["scale"] = torch.cat([scale, scale[:1]])
    elif name == "f64":
        x, delta, chunks = _inputs(torch.float64)
        kw = dict(scale=chunks[1], shift=chunks[0])
    return x, kw


@pytest.mark.parametrize("name,want", [
    ("bf16", True), ("f16", True), ("token_slice", True), ("f32", True),
    ("grad_x", True), ("grad_mod", True), ("transposed", False),
    ("unaligned", False), ("odd_width", False), ("too_wide", False),
    ("mixed_dtype", False), ("broadcast_mod", True),
    ("other_batch_mod", False), ("f64", False)])
def test_kernel_takes_only_what_it_can(name, want):
    """``fits`` is what the CUDA path launches (else it raises); gradients
    wanted do not matter, ``AdaLN`` runs the same forward. On the CPU
    ``adaln`` takes the plain version whatever the tensors."""
    x, kw = _case(name)
    assert adaln.fits(x, **kw) is want
    if name not in ("other_batch_mod", "mixed_dtype"):
        for got, ref in zip(_outs(adaln.adaln(x, **kw)),
                            _outs(adaln.adaln_ref(x, **kw))):
            assert torch.equal(got, ref)


def _row(t, ptr, batch_stride, row_stride, b, s, d):
    """The d values the kernel reads at (b, s) of a tensor given by its
    pointer and strides, from the tensor's own storage."""
    flat = t.new_empty(0).set_(t.untyped_storage())
    start = ((ptr - t.untyped_storage().data_ptr()) // t.element_size()
             + b * batch_stride + s * row_stride)
    return flat[start:start + d]


@pytest.mark.parametrize("name", ["bf16", "token_slice", "broadcast_mod",
                                  "batch1", "batch1_slice"])
def test_kernel_reads_each_row_where_the_tensor_holds_it(name):
    """``_kernel_args``'s pointers and strides, read as the kernel reads
    them, give every row of x and delta and every batch row's modulations
    (a [1, D] one for every row of x), at batch 1 too."""
    x, kw = _case("bf16" if name.startswith("batch1") else name)
    if name.startswith("batch1"):
        x, kw = x[:1], {k: v[:1] for k, v in kw.items()}
        if name == "batch1_slice":
            x, kw["delta"] = x[:, 2:], kw["delta"][:, 1:4]
    assert adaln.fits(x, **kw)
    args = adaln._kernel_args(x, kw["scale"], kw["shift"], kw["gate"],
                              kw["delta"], None, None)
    b, s, d = x.shape
    for i in range(b):
        for j in range(s):
            assert torch.equal(_row(x, *args[0:3], i, j, d), x[i, j])
            assert torch.equal(_row(kw["delta"], *args[3:6], i, j, d),
                               kw["delta"][i, j])
            for k, at in (("gate", 6), ("scale", 8), ("shift", 10)):
                t = kw[k]
                assert torch.equal(_row(t, args[at], args[at + 1], 0, i, 0,
                                        d), t[min(i, t.shape[0] - 1)])
    assert args[12:] == (0, 0)


# ------------------------------------------------ the gradient under autograd
def _leaves(mode, dtype, seed=7):
    x, delta, chunks = _inputs(dtype, seed)
    kw = _args(mode, chunks, delta)
    x = x.clone().requires_grad_()
    kw = {k: v.clone().requires_grad_() for k, v in kw.items()}
    return x, kw


def _grads(fn, x, kw, seed=8):
    """The inputs' gradients of sum(out * w), w fixed random weights."""
    g = torch.Generator().manual_seed(seed)
    outs = _outs(fn(x, **kw))
    loss = sum((o.double() * torch.randn(o.shape, generator=g,
                                         dtype=torch.float64)).sum()
               for o in outs)
    ins = [x, *kw.values()]
    return outs, torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_adaln_gradient_is_the_plain_versions(mode, dtype):
    """Under autograd ``adaln`` goes through ``AdaLN``: its outputs and its
    inputs' gradients are those of autograd through ``adaln_ref``, bit for
    bit."""
    x, kw = _leaves(mode, dtype)
    outs, got = _grads(adaln.adaln, x, kw)
    assert all(type(o.grad_fn).__name__ == "AdaLNBackward" for o in outs)
    ref_outs, want = _grads(adaln.adaln_ref, x, kw)
    for o, r in zip(outs, ref_outs):
        assert torch.equal(o, r)
    for gw, ww in zip(got, want):
        assert gw.dtype == dtype and torch.equal(gw, ww)


@pytest.mark.parametrize("mode", MODES)
def test_adaln_gradcheck(mode):
    """``AdaLN``'s backward against finite differences, in f64."""
    x, kw = _leaves(mode, torch.float64)
    names = list(kw)

    def fn(x, *mods):
        return adaln.adaln(x, **dict(zip(names, mods)))

    assert torch.autograd.gradcheck(fn, (x, *kw.values()))


def test_adaln_without_gradients_keeps_off_autograd():
    """Under no_grad, or on inputs that want no gradient, no ``AdaLN``."""
    x, kw = _leaves("residual+norm", torch.bfloat16)
    with torch.no_grad():
        assert all(o.grad_fn is None for o in adaln.adaln(x, **kw))
    x, kw = x.detach(), {k: v.detach() for k, v in kw.items()}
    assert all(o.grad_fn is None for o in adaln.adaln(x, **kw))


# ----------------------------------------------------- the MMDiT's sites
def _tiny_mmdit(layers, dtype, seed=0):
    torch.manual_seed(seed)
    m = t_mmdit.MMDiT(t_mmdit.MMDiTConfig(num_layers=layers, **TINY))
    with torch.no_grad():   # AdaLN-zero: give the gates something to pass
        for p in m.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return m.to(dtype)


def _tiny_inputs(dtype):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(2, 4, 8, 8, generator=g).to(dtype),
            torch.tensor([981.0, 311.5]),
            torch.randn(2, 5, 24, generator=g).to(dtype),
            torch.randn(2, 20, generator=g).to(dtype))


def _counting(monkeypatch):
    """Count ``adaln.adaln``'s calls by mode."""
    calls = collections.Counter()
    real = adaln.adaln

    def counted(x, scale=None, shift=None, gate=None, delta=None, **kw):
        calls[adaln._mode(scale, shift, gate, delta)] += 1
        return real(x, scale, shift, gate, delta, **kw)

    monkeypatch.setattr(adaln, "adaln", counted)
    return calls


@pytest.mark.parametrize("layers", [2, 3])
def test_mmdit_sends_6L_minus_1_sites_to_the_kernel(monkeypatch, layers):
    """A bf16 forward calls ``adaln`` 6 times a block (norm1,
    norm1_context; the two residual + norms and the two trailing residuals
    of _finish), 4 times in the last (context_pre_only) block and once for
    norm_out: 6L - 1, 143 at SD3-medium's 24 blocks, each one launch on a
    GPU. Its output stays within bf16 round-off of the eager
    composition's."""
    m = _tiny_mmdit(layers, torch.bfloat16)
    with torch.no_grad():
        with monkeypatch.context() as mp:
            mp.setattr(adaln, "adaln", _composition)
            plain = m(*_tiny_inputs(torch.bfloat16))
        calls = _counting(monkeypatch)
        got = m(*_tiny_inputs(torch.bfloat16))
    assert sum(calls.values()) == 6 * layers - 1
    assert calls == {0: 2 * layers + 1, 1: 2 * layers - 1, 2: 2 * layers - 1}
    err = ((got - plain).norm() / plain.norm()).item()
    assert err < 2e-2, err


@pytest.mark.parametrize("dtype,grad", [(torch.bfloat16, False),
                                        (torch.float32, False),
                                        (torch.bfloat16, True)])
def test_mmdit_takes_the_plain_form_off_the_kernel(monkeypatch, dtype, grad):
    """On the CPU, whatever the dtype and under autograd too, every site of
    a forward takes ``adaln_ref`` and none the CUDA path."""
    m = _tiny_mmdit(2, dtype)
    refs = collections.Counter()
    real_ref = adaln.adaln_ref

    def counted_ref(*a, **kw):
        refs["adaln_ref"] += 1
        return real_ref(*a, **kw)

    def no_cuda(*a, **kw):
        raise AssertionError("the CUDA path on the CPU")

    monkeypatch.setattr(adaln, "adaln_ref", counted_ref)
    monkeypatch.setattr(adaln, "_adaln_cuda", no_cuda)
    with torch.set_grad_enabled(grad):
        out = m(*_tiny_inputs(dtype))
    assert refs == {"adaln_ref": 6 * 2 - 1}
    assert (out.grad_fn is not None) is grad


@pytest.mark.parametrize("routed", [False, True])
def test_mmdit_gradient_is_the_plain_forms(monkeypatch, routed):
    """An f32 MMDiT's loss under autograd is the eager composition's bit for
    bit and its parameter gradients are the composition's to f32 round-off
    (autograd sums the LayerNorm's terms, and a stream's two uses, in
    another order): through ``adaln_ref`` alone and through ``AdaLN``
    (``routed``, the path on a GPU too)."""
    m = _tiny_mmdit(2, torch.float32)

    def grads(fn):
        with monkeypatch.context() as mp:
            mp.setattr(adaln, "adaln", fn)
            m.zero_grad()
            loss = m(*_tiny_inputs(torch.float32)).square().mean()
            loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in m.named_parameters()}

    want_loss, want = grads(_composition)
    loss, got = grads(adaln.adaln if routed else adaln.adaln_ref)
    assert torch.equal(loss, want_loss)
    assert want.keys() == got.keys()
    for n in want:
        torch.testing.assert_close(got[n], want[n], msg=n)


# ---------------------------------------------------- the stream's layout
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_is_token_major(dtype):
    """Both streams enter and leave every block as contiguous [B, S, D]
    rows, and norm_out's output too."""
    m = _tiny_mmdit(2, dtype)
    seen = []

    def pre(mod, args):
        seen.extend(args[:2])

    def post(mod, args, out):
        seen.extend(t for t in _outs(out) if t is not None)

    for blk in m.transformer_blocks:
        blk.register_forward_pre_hook(pre)
        blk.register_forward_hook(post)
    m.norm_out.register_forward_hook(post)
    with torch.no_grad():
        m(*_tiny_inputs(dtype))
    assert len(seen) == 2 + 2 + 2 + 1 + 1
    for t in seen:
        assert t.dim() == 3 and t.is_contiguous(), t.stride()


class _Ops(TorchDispatchMode):
    """Each op's name with its output's shape, and each clone's input's
    shape and strides."""

    def __init__(self):
        super().__init__()
        self.ops, self.clones = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if isinstance(out, torch.Tensor):
            self.ops.append((name, tuple(out.shape)))
        if name == "clone":
            self.clones.append((tuple(args[0].shape), args[0].stride()))
        return out


def test_block_forward_copies_no_stream_and_fuses_its_biases():
    """A bf16 joint block's forward: no copy of a transposed stream, the
    image stream's projections and MLP as addmm (bias in the GEMM), and one
    copy of the stream's size left, the attention output's image slice
    before to_out (fusing the projections into a joint buffer is later
    work)."""
    m = _tiny_mmdit(2, torch.bfloat16)
    _, t, ctx, pooled = _tiny_inputs(torch.bfloat16)
    blk = m.transformer_blocks[0]
    b, s_img, dim = 2, (8 // 2) ** 2, 32
    with torch.no_grad():
        emb = (m.time_text_embed.timestep_embedder(
            t_mmdit.timestep_embedding(t, 256).bfloat16())
            + m.time_text_embed.text_embedder(pooled))
        xs = torch.randn(b, s_img, dim).bfloat16()
        cs = m.context_embedder(ctx)
        with _Ops() as seen:
            blk(xs, cs, emb)
    stream = [st for shape, st in seen.clones if shape == (b, s_img, dim)]
    assert len(stream) == 1 and stream[0][-1] == 1, seen.clones
    image_rows = collections.Counter(
        name for name, shape in seen.ops
        if name in ("addmm", "mm") and shape[0] == b * s_img)
    # to_q, to_k, to_v, ff.net.0.proj, ff.net.2; to_out on the slice
    assert image_rows == {"addmm": 5, "mm": 1}, seen.ops


def test_patch_embed_leaves_the_stream_contiguous():
    m = _tiny_mmdit(2, torch.float32)
    seen = {}
    m.transformer_blocks[0].register_forward_pre_hook(
        lambda mod, args: seen.update(x=args[0]))
    with torch.no_grad():
        m(*_tiny_inputs(torch.float32))
    b, s, d = seen["x"].shape
    assert seen["x"].stride() == (s * d, d, 1)
    np.testing.assert_equal((b, s, d), (2, 16, 32))
