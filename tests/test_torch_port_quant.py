"""The port's W8A8 int8 (ops/quant.py, models/layers.QDense) and the
int8-QK^T attention's plain version against the JAX package on the CPU.

The int8 weights and activations must equal the JAX package's bit for bit
(both round half to even; ties are seeded on purpose), the quantized layer
sets must be the same for a tiny MMDiT and a tiny UNet, and
``attention_i8_ref`` must agree with the TPU kernel run in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.ops import attention as j_attn
from safe_denoiser_tpu.ops import quant as j_quant
from safe_denoiser_tpu_torch.models import layers as t_layers
from safe_denoiser_tpu_torch.models import mmdit as t_mmdit
from safe_denoiser_tpu_torch.models import unet as t_unet
from safe_denoiser_tpu_torch.models.weights_export import from_jax_params
from safe_denoiser_tpu_torch.ops import attention as t_attn
from safe_denoiser_tpu_torch.ops import quant as t_quant
from tests.test_torch_port_models import UNET_KW, jax_unet
from tests.test_torch_port_sd3 import MMDIT_KW, jax_mmdit


def _with_ties(rs, rows, cols):
    """Rows whose amax is 127, so the scale is exactly 1 and every value
    that ends in .5 is a rounding tie (half to even: 0.5 -> 0, 1.5 -> 2,
    -2.5 -> -2)."""
    a = rs.randint(-254, 255, (rows, cols)).astype(np.float32) / 2.0
    a[:, 0] = 127.0
    a[::2, 0] = -127.0
    return a


def test_quantized_weights_equal_jax():
    rs = np.random.RandomState(0)
    w_kn = np.concatenate([_with_ties(rs, 24, 40).T,
                           rs.randn(40, 16).astype(np.float32) * 0.3], 1)
    wq_j, sw_j = j_quant.quantize_dense_kernel(jnp.asarray(w_kn))
    wq_t, sw_t = t_quant.quantize_dense_kernel(torch.from_numpy(w_kn.T.copy()))
    assert wq_t.dtype == torch.int8
    np.testing.assert_array_equal(wq_t.numpy().T, np.asarray(wq_j))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))
    ties = w_kn[:, :24] != np.round(w_kn[:, :24] + 0.25)
    assert ties.sum() > 100        # many .5 values, each rounded to even


@pytest.mark.parametrize("ties", [True, False])
def test_int8_dense_equals_jax(ties):
    """Eagerly (no fusion), without bias, the f32 outputs are equal bit
    for bit: the int8 activations, the exact integer products and the
    dequant (y * sx) * sw are the same. With a bias and a bf16 output, the
    outputs agree within one bf16 ulp."""
    rs = np.random.RandomState(1)
    x = (_with_ties(rs, 2 * 7, 64) if ties
         else rs.randn(14, 64).astype(np.float32)).reshape(2, 7, 64)
    w = rs.randn(64, 48).astype(np.float32) / 8.0
    b = rs.randn(48).astype(np.float32)
    wq_j, sw_j = j_quant.quantize_dense_kernel(jnp.asarray(w))
    wq_t, sw_t = t_quant.quantize_dense_kernel(torch.from_numpy(w.T.copy()))
    want = np.asarray(j_quant.int8_dense(jnp.asarray(x), wq_j, sw_j, None,
                                         dtype=jnp.float32))
    got = t_quant.int8_dense(torch.from_numpy(x), wq_t, sw_t, None,
                             dtype=torch.float32)
    assert got.shape == (2, 7, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    want_b = np.asarray(j_quant.int8_dense(jnp.asarray(x), wq_j, sw_j,
                                           jnp.asarray(b), dtype=jnp.bfloat16),
                        np.float32)
    got_b = t_quant.int8_dense(torch.from_numpy(x), wq_t, sw_t,
                               torch.from_numpy(b), dtype=torch.bfloat16)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), want_b, rtol=2 ** -8,
                               atol=1e-6)


def test_qdense_is_linear_on_float_weights_and_int8_after_loading():
    torch.manual_seed(0)
    lin = torch.nn.Linear(32, 24)
    q = t_layers.QDense(32, 24)
    q.load_state_dict(lin.state_dict())
    x = torch.randn(3, 5, 32)
    torch.testing.assert_close(q(x), lin(x), atol=0, rtol=0)
    sd, scales = t_quant._quantize_state_dict(
        {"weight": q.weight.detach()}, lambda n, w: True, "test")
    q.set_int8(sd["weight"], scales["weight_scale"])
    assert "weight_scale" not in q.state_dict()        # never stored
    want = t_quant.int8_dense(x, sd["weight"], scales["weight_scale"],
                              q.bias, torch.float32)
    torch.testing.assert_close(q(x), want, atol=0, rtol=0)
    q.weight_scale = q.weight_scale.bfloat16()
    with pytest.raises(ValueError, match="f32 scales"):
        q(x)


def _path_map(jax_tree, cfg):
    """torch weight key -> JAX parameter path of every kernel, found by
    carrying a tree whose kernels hold their own index through
    ``from_jax_params``."""
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    paths, leaves = [], []
    for kp, leaf in flat:
        path = tuple(k.key for k in kp)
        if path[-1] == "kernel":
            leaves.append(np.full(leaf.shape, len(paths), np.float32))
            paths.append(path)
        else:
            leaves.append(np.asarray(leaf))
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax_tree), leaves)
    sd = from_jax_params(tagged, cfg)
    return {k: paths[int(v.flat[0])] for k, v in sd.items()
            if k.endswith(".weight") and v.ndim >= 2
            and v.size and np.all(v == v.flat[0])
            and int(v.flat[0]) < len(paths)
            and paths[int(v.flat[0])][-1] == "kernel"}


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("model", ["mmdit", "unet_16", "unet_33"])
def test_quantized_layer_sets_equal_jax(model):
    """The same linears quantize in both packages, to the same int8
    weights and scales: all block projections and MLPs of a tiny MMDiT
    (the last block has no to_add_out / ff_context), and the UNet's
    transformer-block linears with min(N, K) >= min_dim (33 keeps the
    64-wide mid block and drops level 0 and the 32-wide cross k/v)."""
    if model == "mmdit":
        _, params = jax_mmdit()
        cfg = t_mmdit.MMDiTConfig(**MMDIT_KW)
        jq, qt = j_quant.quantize_mmdit_params(params["params"])
        sd = {k: torch.from_numpy(v)
              for k, v in from_jax_params(params, cfg).items()}
        tq, scales = t_quant.quantize_mmdit_params(sd)
    else:
        min_dim = {"unet_16": 16, "unet_33": 33}[model]
        _, params = jax_unet()
        cfg = t_unet.UNetConfig(**UNET_KW)
        jq, qt = j_quant.quantize_unet_params(params["params"], min_dim)
        sd = {k: torch.from_numpy(v)
              for k, v in from_jax_params(params, cfg).items()}
        tq, scales = t_quant.quantize_unet_params(sd, min_dim)
    paths = _path_map(params["params"], cfg)
    want = {k for k, p in paths.items()
            if np.asarray(_node(jq, p)).dtype == np.int8}
    got = {k for k, v in tq.items() if v.dtype == torch.int8}
    assert got == want and got
    assert set(scales) == {k[:-len("weight")] + "weight_scale" for k in got}
    for k in got:
        np.testing.assert_array_equal(tq[k].numpy().T,
                                      np.asarray(_node(jq, paths[k])))
        np.testing.assert_array_equal(
            scales[k[:-len("weight")] + "weight_scale"].numpy(),
            np.asarray(_node(qt, paths[k][:-1])["kernel_scale"]))
    if model == "mmdit":
        n_blocks = MMDIT_KW["num_layers"]
        assert len(got) == 12 * (n_blocks - 1) + 9


def test_requantizing_raises():
    _, params = jax_mmdit()
    sd = {k: torch.from_numpy(v) for k, v in from_jax_params(
        params, t_mmdit.MMDiTConfig(**MMDIT_KW)).items()}
    tq, _ = t_quant.quantize_mmdit_params(sd)
    with pytest.raises(ValueError, match="already int8"):
        t_quant.quantize_mmdit_params(tq)
    with pytest.raises(ValueError, match="no .* kernels"):
        t_quant.quantize_unet_params(sd)


# ---------------------------------------------------------- int8-QK^T
def _jax_i8(q, k, v, sm_scale):
    """The TPU kernel (quant_i8) in interpret mode on [B, S, H, D] inputs,
    padded to its 512 grid with the tail keys masked (valid_kv)."""
    b, s, h, d = q.shape
    s_pad = -(-s // 512) * 512
    pad = ((0, 0), (0, s_pad - s), (0, 0), (0, 0))
    q, k, v = (jnp.pad(jnp.asarray(t), pad) for t in (q, k, v))
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, s_pad, d)
    kt = k.transpose(0, 2, 3, 1).reshape(b * h, d, s_pad)
    vf = v.transpose(0, 2, 1, 3).reshape(b * h, s_pad, d)
    out = j_attn._self_attention_bhsd(
        qf, kt, vf, sm_scale=sm_scale,
        valid_kv=s if s_pad != s else None, quant_i8=True, interpret=True)
    return np.asarray(out.reshape(b, h, s_pad, d).transpose(0, 2, 1, 3)[:, :s],
                      np.float32)


@functools.lru_cache(maxsize=None)
def _i8_case(s, d, zero_rows):
    rs = np.random.RandomState(s + d)
    q, k, v = (rs.randn(1, s, 2, d).astype(np.float32) for _ in range(3))
    if zero_rows:
        q[0, 3] = 0.0
        k[0, 5] = 0.0
        k[0, s - 1] = 0.0
    return q, k, v


@pytest.mark.parametrize("s,d,zero_rows", [(600, 40, False),
                                           (512, 64, True)])
def test_attention_i8_ref_matches_the_tpu_kernel(s, d, zero_rows):
    """f32 inputs: the same int8 values and integer logits, so the two
    agree to f32 round-off of the softmax (atol 2e-5). S=600 exercises
    the tail mask (padded to 1024, 424 masked keys), D=40 the pad to 64;
    all-zero q rows and k tokens take the 1e-20 guard."""
    q, k, v = _i8_case(s, d, zero_rows)
    want = _jax_i8(q, k, v, d ** -0.5)
    got = t_attn.attention_i8_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                                  d ** -0.5)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_attention_i8_ref_matches_the_tpu_kernel_in_bf16():
    """bf16 inputs: both round P to bf16 for P V, the kernel before and
    the plain version after normalizing, so they agree within the bf16
    attention bound (BF16_ATOL)."""
    q, k, v = _i8_case(600, 40, False)
    qb, kb, vb = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    want = _jax_i8(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                     for t in (qb, kb, vb)), 40 ** -0.5)
    got = t_attn.attention_i8_ref(qb, kb, vb, 40 ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=t_attn.BF16_ATOL, rtol=0)


def test_int8_attention_dispatch(monkeypatch):
    """SDT_INT8_ATTN=1 sends bf16 self-attention to the int8-QK^T form
    (on the CPU its plain version), through the model layers' dispatch
    too; f32 always bypasses it; without the switch bf16 takes the bf16
    form."""
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(1, 512, 2, 64).astype(np.float32))
               for _ in range(3))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    scale = 64 ** -0.5
    i8 = t_attn.attention_i8_ref(qb, kb, vb, scale)
    plain = t_attn.attention_ref(qb, kb, vb, scale)
    assert not torch.equal(i8, plain)
    monkeypatch.setenv("SDT_INT8_ATTN", "1")
    assert torch.equal(t_attn.self_attention(qb, kb, vb, scale), i8)
    assert torch.equal(t_layers.dot_product_attention(qb, kb, vb), i8)
    assert torch.equal(t_attn.self_attention(q, k, v, scale),
                       t_attn.attention_ref(q, k, v, scale))
    monkeypatch.setenv("SDT_INT8_ATTN", "0")
    assert torch.equal(t_attn.self_attention(qb, kb, vb, scale), plain)
