"""The port's models (UNet, VAE, CLIP text encoder) against the JAX package
on the CPU, in f32, on the same weights.

JAX parameter trees get the shapes of a flax init and numpy-seeded values
(no leaf keeps a trivial init such as zero biases or unit norms);
``from_jax_params`` turns them into diffusers/HF state dicts that load into
the port with ``strict=True``. Tolerance: atol 1e-4, the bar of the JAX
package's torch goldens (f32 round-off through a few blocks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.models import clip_text as j_clip
from safe_denoiser_tpu.models import unet as j_unet
from safe_denoiser_tpu.models import vae as j_vae
from safe_denoiser_tpu_torch.models import clip_text as t_clip
from safe_denoiser_tpu_torch.models import unet as t_unet
from safe_denoiser_tpu_torch.models import vae as t_vae
from safe_denoiser_tpu_torch.models.weights_export import from_jax_params
from safe_denoiser_tpu_torch.ops.conv3x3 import conv3x3_ref as c3_ref

TOL = dict(atol=1e-4, rtol=1e-4)

UNET_KW = dict(sample_size=24, block_out_channels=(32, 64),
               layers_per_block=1, cross_attention_dim=32,
               num_attention_heads=2, norm_num_groups=8)
VAE_KW = dict(block_out_channels=(32, 64), layers_per_block=1,
              norm_num_groups=8)
CLIP_KW = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=2,
               max_position_embeddings=16, intermediate_size=64,
               eos_token_id=119)


def random_params(model, seed: int, *args):
    """A parameter tree of ``model`` filled from a numpy RandomState: the
    shapes come from tracing ``model.init`` (no JAX initializers run);
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.05^2), everything
    else ~ N(0, 0.05^2)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(model.init, *args)

    def fill(path, leaf):
        name = str(path[-1])
        shape = leaf.shape
        if "kernel" in name:
            std = 1.0 / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        else:
            std = 0.05
        a = rs.randn(*shape) * std
        if "scale" in name:
            a = a + 1.0
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(module, params, cfg, **kw):
    sd = {k: torch.from_numpy(v)
          for k, v in from_jax_params(params, cfg, **kw).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


@functools.lru_cache(maxsize=None)
def jax_unet(seed=0):
    cfg = j_unet.UNetConfig(**UNET_KW)
    model = j_unet.UNet2DCondition(cfg)
    return model, random_params(model, seed, jax.random.PRNGKey(0),
                                jnp.zeros((1, 24, 24, 4)), jnp.zeros((1,)),
                                jnp.zeros((1, 5, 32)))


def torch_unet(params):
    cfg = t_unet.UNetConfig(**UNET_KW)
    return load(t_unet.UNet2DConditionModel(cfg), params, cfg)


@functools.lru_cache(maxsize=None)
def jax_vae(seed=1):
    cfg = j_vae.VAEConfig(**VAE_KW)
    model = j_vae.AutoencoderKL(cfg)
    rng = jax.random.PRNGKey(0)
    return model, random_params(model, seed, {"params": rng},
                                jnp.zeros((1, 16, 16, 3)), rng)


def torch_vae(params):
    cfg = t_vae.VAEConfig(**VAE_KW)
    return load(t_vae.AutoencoderKL(cfg), params, cfg)


@functools.lru_cache(maxsize=None)
def jax_clip(seed=2):
    cfg = j_clip.CLIPTextConfig(**CLIP_KW)
    model = j_clip.CLIPTextModel(cfg)
    return model, random_params(model, seed, jax.random.PRNGKey(0),
                                jnp.zeros((1, 16), jnp.int32))


def torch_clip(params, with_projection=False):
    cfg = t_clip.CLIPTextConfig(**CLIP_KW)
    return load(t_clip.CLIPTextModel(cfg, with_projection), params, cfg,
                with_projection=with_projection)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("t", [981, 21])
def test_unet_matches_jax(t):
    """24x24 latents: the level-0 self-attention (S=576, a padded tail in
    the JAX kernel) goes through ops.attention.self_attention, the level-1
    one (S=144) the plain einsum form."""
    model, params = jax_unet()
    rs = np.random.RandomState(3)
    x = rs.randn(2, 24, 24, 4).astype(np.float32)
    ctx = rs.randn(2, 5, 32).astype(np.float32)
    want = jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx))
    with torch.no_grad():
        got = torch_unet(params)(torch.from_numpy(_nchw(x).copy()), t,
                                 torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _nchw(want), **TOL)


def test_vae_decode_matches_jax():
    model, params = jax_vae()
    z = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    want = jax.jit(lambda p, z: model.apply(
        p, z, method=j_vae.AutoencoderKL.decode))(params, jnp.asarray(z))
    with torch.no_grad():
        got = torch_vae(params).decode(torch.from_numpy(_nchw(z).copy()))
    np.testing.assert_allclose(got.numpy(), _nchw(want), **TOL)


def test_vae_encode_matches_jax():
    model, params = jax_vae()
    x = np.random.RandomState(5).uniform(-1, 1, (2, 16, 16, 3)
                                         ).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: model.apply(
        p, x, method=j_vae.AutoencoderKL.encode))(params, jnp.asarray(x))
    with torch.no_grad():
        gm, gl = torch_vae(params).encode(torch.from_numpy(_nchw(x).copy()))
    np.testing.assert_allclose(gm.numpy(), _nchw(mean), **TOL)
    np.testing.assert_allclose(gl.numpy(), _nchw(logvar), **TOL)


def test_vae_decode_fused_matches_jax(monkeypatch):
    """The VAE decoder in its default (fused) form, bf16: 128-channel
    blocks at 16^2 and 32^2, so every resnet takes the fused conv -- in the
    JAX package through the Pallas kernel in interpret mode
    (SDT_PALLAS_CONV=interpret), in the port through conv3x3's plain
    version. Tolerance: rms of the difference <= 2% of the image's rms
    (bf16 roundings in another order through six resnets and the
    mid-block attention)."""
    monkeypatch.setenv("SDT_PALLAS_CONV", "interpret")
    kw = dict(block_out_channels=(128, 128), layers_per_block=1,
              norm_num_groups=32)
    model = j_vae.AutoencoderKL(j_vae.VAEConfig(**kw), dtype=jnp.bfloat16)
    rng = jax.random.PRNGKey(0)
    params = random_params(model, 6, {"params": rng},
                           jnp.zeros((1, 32, 32, 3)), rng)
    z = np.random.RandomState(7).randn(1, 16, 16, 4).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(z),
                                  method=j_vae.AutoencoderKL.decode),
                      np.float32)
    cfg = t_vae.VAEConfig(**kw)
    vae = load(t_vae.AutoencoderKL(cfg), params, cfg).to(torch.bfloat16)
    calls = []
    monkeypatch.setattr(t_vae.c3, "conv3x3_ref",
                        lambda *a, **k: calls.append(1) or
                        c3_ref(*a, **k))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(_nchw(z).copy())).float().numpy()
    assert len(calls) == 12           # 6 resnets x 2 fused convs
    d = got - _nchw(want)
    rel = np.sqrt((d ** 2).mean() / (want ** 2).mean())
    assert rel <= 2e-2, rel


@pytest.mark.parametrize("with_projection", [False, True])
def test_clip_text_matches_jax(with_projection):
    model, params = jax_clip()
    ids = np.random.RandomState(6).randint(0, 119, (2, 16))
    ids[0, 7] = ids[1, 12] = 119                        # EOS positions
    want = jax.jit(model.apply)(params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = torch_clip(params, with_projection)(torch.from_numpy(ids))
    n = 4 if with_projection else 3     # without a head, projected == pooled
    for g, w in zip(got[:n], want[:n]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_packed_up_weights_follow_the_module():
    """The up-conv's packed weights are built once per module and rebuilt
    when load_state_dict or an in-place update changes the weights, or .to
    replaces them."""
    from safe_denoiser_tpu_torch.ops import conv3x3 as t_conv
    up = t_unet.Upsample2D(32)
    first = t_unet._packed_up_weights(up.conv)
    assert t_unet._packed_up_weights(up.conv) is first
    for change in (
            lambda: up.load_state_dict({k: v + 1.0 for k, v in
                                        up.state_dict().items()}),
            lambda: up.conv.bias.requires_grad_(False).mul_(2.0),
            lambda: up.to(torch.float64)):
        before = t_unet._packed_up_weights(up.conv)
        change()
        got = t_unet._packed_up_weights(up.conv)
        assert got is not before
        want = t_conv.pack_weights(up.conv.weight, up.conv.bias)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_bridge_matches_jax_converters():
    """from_jax_params and the JAX package's converters are inverses: the
    state dict converts back to the same tree."""
    from safe_denoiser_tpu.models import weights as W
    _, params = jax_vae()
    sd = from_jax_params(params, t_vae.VAEConfig(**VAE_KW))
    back = W.convert_vae(sd, j_vae.VAEConfig(**VAE_KW))
    a = jax.tree_util.tree_leaves_with_path(back)
    b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(a) == len(b)
    for path, leaf in a:
        np.testing.assert_array_equal(leaf, b[path])
