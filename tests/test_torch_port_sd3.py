"""The port's SD3 slice against the JAX package on the CPU, in f32, on the
same weights: the flow-match tables, the T5 and CLIP-bigG towers, the
MMDiT (with and without qk RMS-norm), the joint text embedding, the
SAFREE projection, the flow-match loop with and without repellency on the
JAX noise stream, the pipeline from a tiny HF-layout checkpoint, and the
int8 MMDiT loop against the JAX package's quantized scan.

Weights: JAX parameter trees with numpy-seeded values
(``test_torch_port_models.random_params``), carried into the port's state
dicts by ``from_jax_params``. Tolerances are stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.models import clip_text as j_clip
from safe_denoiser_tpu.models import mmdit as j_mmdit
from safe_denoiser_tpu.models import t5 as j_t5
from safe_denoiser_tpu.schedulers import flow_match as j_fm
from safe_denoiser_tpu_torch.models import clip_text as t_clip
from safe_denoiser_tpu_torch.models import mmdit as t_mmdit
from safe_denoiser_tpu_torch.models import t5 as t_t5
from safe_denoiser_tpu_torch.schedulers import flow_match as t_fm
from tests.test_torch_port_models import load, random_params

TOL = dict(atol=1e-4, rtol=1e-4)

MMDIT_KW = dict(sample_size=16, patch_size=2, in_channels=4, out_channels=4,
                num_layers=2, num_heads=2, head_dim=16, joint_attention_dim=24,
                caption_projection_dim=32, pooled_projection_dim=20,
                pos_embed_max_size=12)
T5_KW = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
             num_heads=4, relative_attention_num_buckets=8,
             relative_attention_max_distance=20)
BIGG_KW = dict(vocab_size=120, hidden_size=40, num_layers=3, num_heads=4,
               max_position_embeddings=16, intermediate_size=80,
               hidden_act="gelu", projection_dim=24, eos_token_id=119)


# ----------------------------------------------------------------- tables
@pytest.mark.parametrize("shift,steps", [(3.0, 50), (3.0, 7), (1.75, 28)])
def test_flow_match_tables_match_jax(shift, steps):
    want = j_fm.FlowMatchEulerScheduler(j_fm.FlowMatchEulerConfig(
        shift=shift)).timesteps_and_sigmas(steps)
    got = t_fm.FlowMatchEulerScheduler(t_fm.FlowMatchEulerConfig(
        shift=shift)).timesteps_and_sigmas(steps)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_flow_match_config_honours_the_checkpoint(tmp_path):
    assert t_fm.flow_match_config_from_checkpoint(str(tmp_path)) == \
        t_fm.FlowMatchEulerConfig()
    (tmp_path / "scheduler_config.json").write_text(
        '{"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 1.75,'
        ' "num_train_timesteps": 1000, "use_dynamic_shifting": false}')
    assert t_fm.flow_match_config_from_checkpoint(str(tmp_path)).shift == 1.75


# ----------------------------------------------------------------- towers
@functools.lru_cache(maxsize=None)
def jax_mmdit(qk_norm=None, seed=11):
    cfg = j_mmdit.MMDiTConfig(**MMDIT_KW, qk_norm=qk_norm)
    model = j_mmdit.MMDiT(cfg)
    return model, random_params(model, seed, jax.random.PRNGKey(0),
                                jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                jnp.zeros((1, 5, 24)), jnp.zeros((1, 20)))


def torch_mmdit(params, qk_norm=None):
    cfg = t_mmdit.MMDiTConfig(**MMDIT_KW, qk_norm=qk_norm)
    return load(t_mmdit.MMDiT(cfg), params, cfg)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("qk_norm", [None, "rms_norm"])
def test_mmdit_matches_jax(qk_norm):
    """8x8 latents (16 patches) + 5 context tokens through two joint blocks
    (the second context_pre_only); the 21-token joint attention takes the
    plain form in both packages. Tolerance TOL (f32 round-off)."""
    model, params = jax_mmdit(qk_norm)
    rs = np.random.RandomState(12)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 5, 24).astype(np.float32)
    pooled = rs.randn(2, 20).astype(np.float32)
    t = np.array([981.0, 311.5], np.float32)
    want = jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx), jnp.asarray(pooled))
    with torch.no_grad():
        got = torch_mmdit(params, qk_norm)(
            torch.from_numpy(_nchw(x).copy()), torch.from_numpy(t),
            torch.from_numpy(ctx), torch.from_numpy(pooled))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _nchw(want), **TOL)


def test_pos_embed_crop_matches_the_full_table():
    """The port computes only the crop it uses; its entries equal the JAX
    package's full table cropped."""
    full = np.asarray(j_mmdit._pos_embed_2d(32, 12, 8)).reshape(12, 12, 32)
    crop = t_mmdit.pos_embed_2d(32, 12, 8, top=3, left=2, rows=6, cols=8)
    np.testing.assert_array_equal(crop.astype(np.float32),
                                  full[3:9, 2:10].reshape(-1, 32))


def test_t5_matches_jax():
    """Two blocks with the shared relative-position bias over 21 tokens
    (beyond max_exact, so the log buckets are used). Tolerance TOL."""
    cfg = j_t5.T5Config(**T5_KW)
    model = j_t5.T5Encoder(cfg)
    params = random_params(model, 13, jax.random.PRNGKey(0),
                           jnp.zeros((1, 21), jnp.int32))
    ids = np.random.RandomState(14).randint(0, 64, (2, 21))
    want = jax.jit(model.apply)(params, jnp.asarray(ids, jnp.int32))
    tcfg = t_t5.T5Config(**T5_KW)
    mine = load(t_t5.T5Encoder(tcfg), params, tcfg)
    with torch.no_grad():
        got = mine(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_big_g_matches_jax():
    """The bigG tower's form (exact-erf gelu, a projection head) at a small
    width; the preset itself equals the JAX package's."""
    import dataclasses
    assert dataclasses.asdict(t_clip.CLIP_BIG_G) == \
        dataclasses.asdict(j_clip.CLIP_BIG_G)
    cfg = j_clip.CLIPTextConfig(**BIGG_KW)
    model = j_clip.CLIPTextModel(cfg)
    params = random_params(model, 15, jax.random.PRNGKey(0),
                           jnp.zeros((1, 16), jnp.int32))
    ids = np.random.RandomState(16).randint(0, 119, (2, 16))
    ids[0, 9] = ids[1, 15] = 119
    want = jax.jit(model.apply)(params, jnp.asarray(ids, jnp.int32))
    tcfg = t_clip.CLIPTextConfig(**BIGG_KW)
    mine = load(t_clip.CLIPTextModel(tcfg, with_projection=True), params,
                tcfg, with_projection=True)
    with torch.no_grad():
        got = mine(torch.from_numpy(ids))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# -------------------------------------------------------------- text side
def test_joint_text_embed_matches_jax():
    from safe_denoiser_tpu.pipeline.diffusion_sd3 import \
        joint_text_embed as j_embed
    from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
        joint_text_embed as t_embed
    rs = np.random.RandomState(20)
    parts = [rs.randn(*s).astype(np.float32) for s in
             ((2, 7, 12), (2, 16), (2, 7, 20), (2, 24), (2, 9, 48))]
    want = j_embed(*(jnp.asarray(p) for p in parts), 48)
    got = t_embed(*(torch.from_numpy(p) for p in parts), 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (2, 16, 48) and got[1].shape == (2, 40)


def test_safree_projection_matches_jax():
    """Leave-one-out trigger tokens and their projection, f32 (pinv of a
    well-conditioned Gram matrix; atol 1e-5)."""
    from safe_denoiser_tpu.pipeline import safree as j_safree
    from safe_denoiser_tpu_torch.pipeline import safree as t_safree
    rs = np.random.RandomState(21)
    emb = rs.randn(2, 12, 32).astype(np.float32)
    neg = rs.randn(32, 5).astype(np.float32)
    masked = rs.randn(6, 32).astype(np.float32)
    masked[2] = neg[:, 0] * 3.0        # one token inside the concept span
    j_c = j_safree.projection_matrix(jnp.asarray(neg))
    t_c = t_safree.projection_matrix(torch.from_numpy(neg))
    np.testing.assert_allclose(t_c.numpy(), np.asarray(j_c), atol=1e-5)
    j_m = j_safree.projection_matrix(jnp.asarray(masked.T))
    t_m = t_safree.projection_matrix(torch.from_numpy(masked.T.copy()))
    want = j_safree.safree_projection(jnp.asarray(emb), jnp.asarray(masked),
                                      j_m, j_c, alpha=0.01, max_length=12)
    got = t_safree.safree_projection(torch.from_numpy(emb),
                                     torch.from_numpy(masked), t_m, t_c,
                                     alpha=0.01, max_length=12)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    assert got[1] == int(want[1]) and got[1] >= 1
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ------------------------------------------------------------------ loop
B, HW, STEPS = 2, 8, 6
RNG = jax.random.PRNGKey(77)


def _jax_noise(rng, shape_nhwc):
    """The JAX loop's renoise stream for injection: fold_in(fold_in(rng,
    i), 1), as [B, C, H, W]."""
    def noise(i, salt):
        k = jax.random.fold_in(jax.random.fold_in(rng, i), salt)
        n = jax.random.normal(k, shape_nhwc, dtype=jnp.float32)
        return torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())
    return noise


def _loop_inputs(seed=22):
    rs = np.random.RandomState(seed)
    lat0 = rs.randn(B, HW, HW, 4).astype(np.float32)
    ctx = rs.randn(2, B, 7, 24).astype(np.float32)
    pooled = rs.randn(2, B, 20).astype(np.float32)
    refs = rs.randn(5, 4, HW, HW).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    return lat0, ctx, pooled, refs


def _run_both(j_vars, t_model, use_rep, guidance=2.5):
    from safe_denoiser_tpu.pipeline.sampler import RepellencyWindow as JWin
    from safe_denoiser_tpu.pipeline.sampler import sample_sd3 as j_sample
    from safe_denoiser_tpu.repellency import RepellencyConfig as JRep
    from safe_denoiser_tpu_torch.pipeline import (RepellencyWindow,
                                                  sample_sd3)
    from safe_denoiser_tpu_torch.repellency import RepellencyConfig

    model, _ = jax_mmdit()
    lat0, ctx, pooled, refs = _loop_inputs()
    rkw = dict(method="kernel_fast", sigma=10.0, scale=0.05,
               use_beta_gate=False, normalize_x=True)
    window = (1000.0, 500.0)
    want, want_app = j_sample(
        lambda lat, t, c, p: model.apply(j_vars, lat, t, c, p),
        j_fm.FlowMatchEulerScheduler(), jnp.asarray(ctx),
        jnp.asarray(pooled), jnp.asarray(lat0), RNG, STEPS,
        guidance_scale=guidance, repellency=JRep(**rkw) if use_rep else None,
        refs_nchw=jnp.asarray(refs) if use_rep else None,
        window=JWin(*window))
    with torch.no_grad():
        got, app = sample_sd3(
            t_model, t_fm.FlowMatchEulerScheduler(), torch.from_numpy(ctx),
            torch.from_numpy(pooled),
            torch.from_numpy(_nchw(lat0).copy()),
            _jax_noise(RNG, lat0.shape), STEPS, guidance_scale=guidance,
            repellency=RepellencyConfig(**rkw) if use_rep else None,
            refs=torch.from_numpy(refs) if use_rep else None,
            window=RepellencyWindow(*window))
    return got, app, _nchw(want), np.asarray(want_app)


@pytest.mark.parametrize("use_rep", [False, True], ids=["std", "rep"])
def test_sample_sd3_matches_jax(use_rep):
    """Six flow-match steps with CFG 2.5; with repellency the window
    [1000, 500] splits renoise and Euler steps, and the renoise takes the
    JAX stream's eps. Tolerance as the JAX package's SD3 loop parity (f32
    sums in another order, amplified over the steps): atol 2e-3, rtol
    1e-3."""
    _, params = jax_mmdit()
    got, app, want, want_app = _run_both(params, torch_mmdit(params),
                                         use_rep)
    np.testing.assert_array_equal(app.numpy(), want_app)
    if use_rep:
        assert app.any() and not app.all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)


def test_int8_mmdit_loop_matches_jax_quantized_scan():
    """The W8A8 MMDiT (the port's quantize + load_quantized; the JAX
    package's quantize_mmdit_params) through the loop with repellency, f32
    activations. The int8 weights are equal and one int8 linear on equal
    inputs gives equal outputs (test_torch_port_quant.py), but an
    activation whose scaled value lies within f32 round-off of a .5 tie
    rounds the other way in the two packages, moving its dot by one
    quantization step, and attention spreads that over the tokens. Bound:
    the relative difference stays under 2e-3 and under half the int8
    error itself (JAX int8 against JAX f32); measured 8.3e-4 against
    4.0e-3."""
    from safe_denoiser_tpu.ops import quant as j_quant
    from safe_denoiser_tpu_torch.ops import quant as t_quant
    _, params = jax_mmdit()
    pq, qt = j_quant.quantize_mmdit_params(params["params"])
    model = torch_mmdit(params)
    sd, scales = t_quant.quantize_mmdit_params(model.state_dict())
    n = t_quant.load_quantized(model, sd, scales)
    assert n == 12 * (MMDIT_KW["num_layers"] - 1) + 9
    got, app, want, want_app = _run_both({"params": pq, "quant": qt}, model,
                                         use_rep=True)
    np.testing.assert_array_equal(app.numpy(), want_app)
    want_f = _run_both(params, torch_mmdit(params), use_rep=True)[2]

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    err, int8_err = rel(got.numpy(), want), rel(want, want_f)
    assert err < 2e-3 and err < 0.5 * int8_err, (err, int8_err)


# --------------------------------------------------------------- pipeline
TINY_SD3 = dict(
    mmdit=dict(sample_size=8, patch_size=2, in_channels=4, out_channels=4,
               num_layers=2, num_heads=2, head_dim=8, joint_attention_dim=48,
               caption_projection_dim=16, pooled_projection_dim=40,
               pos_embed_max_size=8),
    t5=dict(vocab_size=528, d_model=48, d_kv=8, d_ff=64, num_layers=2,
            num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=20),
    clip_l=dict(vocab_size=528, hidden_size=16, num_layers=2, num_heads=2,
                intermediate_size=32, projection_dim=16),
    clip_g=dict(vocab_size=528, hidden_size=24, num_layers=2, num_heads=2,
                intermediate_size=48, hidden_act="gelu", projection_dim=24),
    vae=dict(latent_channels=4, block_out_channels=(8, 16),
             layers_per_block=1, norm_num_groups=4, scaling_factor=1.5305,
             shift_factor=0.0609, sample_size=16, use_quant_conv=False,
             use_post_quant_conv=False))


def write_tiny_sd3_checkpoint(root: str, vocab_dir: str, shift: float = 1.75):
    """A tiny HF-layout SD3 checkpoint written from the port's modules (f32,
    seeded, matrices ~ N(0, 0.15^2)): sharded MMDiT, the three towers, the
    16-channel-style VAE, three BPE tokenizer dirs, a scheduler config
    with ``shift``. Returns the port pipeline it was written from."""
    import chip_smoke
    from safe_denoiser_tpu_torch import models as M
    from safe_denoiser_tpu_torch.schedulers import (FlowMatchEulerConfig,
                                                    FlowMatchEulerScheduler)
    pipe = chip_smoke.build_random_sd3_pipeline(
        "cpu", vocab_dir, M.MMDiTConfig(**TINY_SD3["mmdit"]),
        M.T5Config(**TINY_SD3["t5"]),
        M.CLIPTextConfig(**TINY_SD3["clip_l"]),
        M.CLIPTextConfig(**TINY_SD3["clip_g"]),
        M.VAEConfig(**TINY_SD3["vae"]), seed=3, dtype=torch.float32,
        std=0.15)
    pipe.scheduler = FlowMatchEulerScheduler(FlowMatchEulerConfig(
        shift=shift))
    chip_smoke.write_sd3_checkpoint(pipe, root, vocab_dir)
    return pipe


def _jax_sd3_pipeline(root: str):
    """The JAX package's SafeDiffusion3Pipeline on the same checkpoint,
    with f32 towers (its from_pretrained fixes bf16)."""
    import os

    from safe_denoiser_tpu import models as JM
    from safe_denoiser_tpu.models import weights as JW
    from safe_denoiser_tpu.pipeline.diffusion_sd3 import \
        SafeDiffusion3Pipeline
    from safe_denoiser_tpu.text import CLIPTokenizer

    def part(sub, kind, model, convert):
        cfg = JW.load_component_config(os.path.join(root, sub), kind)
        sd = JW.load_sharded_state_dict(os.path.join(root, sub))
        return model(cfg), convert(sd, cfg)

    tf = part("transformer", "mmdit", JM.MMDiT, JW.convert_mmdit)
    vae = part("vae", "vae", JM.AutoencoderKL, JW.convert_vae)
    cl = part("text_encoder", "clip_text", JM.CLIPTextModel,
              JW.convert_clip_text)
    cg = part("text_encoder_2", "clip_text", JM.CLIPTextModel,
              JW.convert_clip_text)
    t5 = part("text_encoder_3", "t5", JM.T5Encoder, JW.convert_t5)
    toks = [CLIPTokenizer.from_pretrained(os.path.join(root, t))
            for t in ("tokenizer", "tokenizer_2", "tokenizer_3")]
    sched = j_fm.FlowMatchEulerScheduler(j_fm.FlowMatchEulerConfig(
        **t_fm.flow_match_config_from_checkpoint(
            os.path.join(root, "scheduler")).__dict__))
    return SafeDiffusion3Pipeline(*tf, *vae, *cl, *cg, *t5, *toks, sched)


def test_pipeline_from_pretrained_matches_jax(tmp_path):
    """A tiny HF-layout checkpoint through both packages' pipelines, f32:
    the scheduler config is honoured; the triple text encode (atol 1e-4)
    and the SAFREE-projected batch embeddings (atol 1e-3) agree; the flow-match
    loop with the pipeline's repellency settings (sigma 1, channel-
    normalized x, no gate) on the JAX noise stream, then the decode of
    latents / scaling + shift, agree (atol 2e-3); the port's
    generate_batch gives uint8 images, and a row's result does not depend
    on the rest of the batch (f32 round-off)."""
    import dataclasses

    import chip_smoke
    from safe_denoiser_tpu.pipeline.sampler import RepellencyWindow as JWin
    from safe_denoiser_tpu.pipeline.sampler import sample_sd3 as j_sample
    from safe_denoiser_tpu_torch.pipeline import RepellencyWindow, sample_sd3
    from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
        SafeDiffusion3Pipeline
    from safe_denoiser_tpu_torch.repellency import KernelFastRepellency

    vocab = tmp_path / "vocab"
    vocab.mkdir()
    chip_smoke.write_tiny_vocab(str(vocab))
    root = str(tmp_path / "sd3")
    written = write_tiny_sd3_checkpoint(root, str(vocab))
    pipe = SafeDiffusion3Pipeline.from_pretrained(root, device="cpu",
                                                  dtype=torch.float32)
    jpipe = _jax_sd3_pipeline(root)
    assert pipe.scheduler.config.shift == 1.75
    for mine, ref in ((pipe.transformer, written.transformer),
                      (pipe.t5, written.t5), (pipe.clip_g, written.clip_g)):
        for (k, a), b in zip(mine.state_dict().items(),
                             ref.state_dict().values()):
            assert torch.equal(a, b), k
    pipe.max_sequence_length = jpipe.max_sequence_length = 12

    emb, pooled = pipe.encode_prompt("a cat", "")
    j_emb, j_pooled = jpipe.encode_prompt("a cat", "")
    assert emb.shape == (2, 1, 77 + 12, 48) and pooled.shape == (2, 1, 40)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j_pooled),
                               atol=1e-4)
    prompts = ["a cat on a sofa", "the dog runs"]
    emb, pooled = pipe._prepare_batch_embeds(prompts, safree=True)
    j_emb, j_pooled = jpipe._prepare_batch_embeds(prompts, safree=True)
    # the projected tokens go through the pseudo-inverse of the masked
    # prompts' Gram matrix, ill-conditioned (their leave-one-out states
    # differ by one token each): f32 round-off grows to ~4e-4
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), atol=1e-3)

    rs = np.random.RandomState(23)
    lat0 = rs.randn(2, 8, 8, 4).astype(np.float32)
    bank = rs.randn(3, 4, 8, 8).astype(np.float32)
    proc = KernelFastRepellency(ref_data=torch.from_numpy(bank),
                                embed_fn=lambda x: x, sigma=2.75,
                                scale=0.03, normalize_x=True, device="cpu")
    cfg = dataclasses.replace(proc.config(), sigma=1.0, normalize_x=True,
                              use_beta_gate=False)
    refs = proc.get_proj_ref()
    rng = jax.random.PRNGKey(5)
    j_lat, j_app = j_sample(
        lambda lat, t, c, p: jpipe.transformer.apply(
            jpipe.transformer_params, lat, t, c, p),
        jpipe.scheduler, j_emb, j_pooled, jnp.asarray(lat0), rng, 4,
        guidance_scale=2.5, repellency=cfg, refs_nchw=jnp.asarray(refs),
        window=JWin(1000.0, 780.0))
    vc = jpipe.vae.config
    j_img = jpipe._vae_decode_jit(jpipe.vae_params,
                                  j_lat / vc.scaling_factor + vc.shift_factor)
    with torch.no_grad():
        lat, app = sample_sd3(pipe.transformer, pipe.scheduler, emb, pooled,
                              torch.from_numpy(_nchw(lat0).copy()),
                              _jax_noise(rng, lat0.shape), 4,
                              guidance_scale=2.5, repellency=cfg, refs=refs,
                              window=RepellencyWindow(1000.0, 780.0))
        img = pipe.vae.decode(lat / vc.scaling_factor + vc.shift_factor)
    np.testing.assert_array_equal(app.numpy(), np.asarray(j_app))
    assert app.any()
    np.testing.assert_allclose(lat.numpy(), _nchw(j_lat), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(img.numpy(), _nchw(j_img), atol=2e-3,
                               rtol=1e-3)

    kw = dict(num_inference_steps=4, height=16, width=16, safree=True,
              repellency_processor=proc)
    pending = pipe.dispatch_batch(prompts, [11, 12], [2.5, 4.0], **kw)
    images = pending.fetch()
    assert [im.shape for im in images] == [(16, 16, 3)] * 2
    assert all(im.dtype == np.uint8 for im in images)
    assert set(pending.stage_ms) == {"encode", "loop", "decode"}
    # shift 1.75 over 4 steps: only t = 1000 lies in [1000, 780]; no gate
    assert pending.applied[0].all() and not pending.applied[1:].any()
    alone = pipe.dispatch_batch(prompts[1:], [12], [4.0], **kw)
    np.testing.assert_allclose(alone.latents[0].numpy(),
                               pending.latents[1].numpy(), atol=1e-4,
                               rtol=1e-4)
