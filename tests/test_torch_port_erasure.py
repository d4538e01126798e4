"""SD-v1's text-side erasure methods through the port against the JAX
package on the CPU (f32): FreeU and the SafeGuard filters (alone and in the
UNet), SAFREE's self-validation filter, the sampler's latent re-attention
mode and per-step context swap on the JAX noise stream, the pipeline's text
preparation for SLD, SAFREE and re-attention on the same tiny weights, and
the nudity runner's erasure flags end to end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from safe_denoiser_tpu.models import clip_text as j_clip
from safe_denoiser_tpu.models import fourier as j_fourier
from safe_denoiser_tpu.pipeline import diffusion as j_diffusion
from safe_denoiser_tpu.pipeline import safree as j_safree
from safe_denoiser_tpu.pipeline import sampler as j_sampler
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPMScheduler
from safe_denoiser_tpu.text import CLIPTokenizer as JCLIPTokenizer
from safe_denoiser_tpu_torch.models import clip_text as t_clip
from safe_denoiser_tpu_torch.models import fourier as t_fourier
from safe_denoiser_tpu_torch.pipeline import diffusion as t_diffusion
from safe_denoiser_tpu_torch.pipeline import safree as t_safree
from safe_denoiser_tpu_torch.pipeline import sampler as t_sampler
from safe_denoiser_tpu_torch.repellency import methods as t_methods
from safe_denoiser_tpu_torch.runners import nudity as t_nudity
from safe_denoiser_tpu_torch.runners.common import \
    NUDITY_NEGATIVE_PROMPT_SPACE
from safe_denoiser_tpu_torch.schedulers import DDPMScheduler
from safe_denoiser_tpu_torch.text import CLIPTokenizer
from tests.test_torch_port_models import (
    _nchw, jax_unet, jax_vae, load, random_params, torch_unet, torch_vae)
from tests.test_torch_port_runner import (  # noqa: F401
    _argv, assets, one_torch_thread)

FREEU = dict(b1=1.1, b2=1.2, s1=0.9, s2=0.2)


def _freeu(pkg, mode="all", **kw):
    return pkg.FreeUConfig(**{**FREEU, "mode": mode, **kw})


# ----------------------------------------------------------------- filters
@pytest.mark.parametrize("mode,in_freeu", [
    ("freeu", False), ("high", False), ("high", True), ("low", False),
    ("all", False)])
def test_skip_filters_match_jax(mode, in_freeu):
    """``apply_skip_filter`` in every mode on random [3, H, W, C], even and
    odd sizes: f32 transforms, atol 1e-5. (tests/test_models.py's linspace
    input is no case here: its rows 1 and 2 differ by a constant, so their
    high bands are equal and the filters' comparisons fall to round-off.)"""
    rs = np.random.RandomState(0)
    for x in (rs.randn(3, 8, 8, 6), rs.randn(3, 16, 16, 4),
              rs.randn(3, 7, 9, 2)):
        x = x.astype(np.float32)
        want = jax.jit(j_fourier.apply_skip_filter, static_argnums=(1, 2))(
            jnp.asarray(x), _freeu(j_fourier, mode, in_freeu=in_freeu), 0.2)
        got = t_fourier.apply_skip_filter(
            torch.from_numpy(x), _freeu(t_fourier, mode, in_freeu=in_freeu),
            0.2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode", ["freeu", "all"])
def test_unet_freeu_matches_jax(mode):
    """The tiny UNet (widths 32, 64) with FreeU on its up path, batch 3
    ([uncond, cond, re-attention]); atol 1e-4, the UNet's."""
    model, params = jax_unet()
    rs = np.random.RandomState(4)
    x = rs.randn(3, 24, 24, 4).astype(np.float32)
    ctx = rs.randn(3, 5, 32).astype(np.float32)
    want = jax.jit(model.apply, static_argnames="freeu")(
        params, jnp.asarray(x), jnp.asarray(501), jnp.asarray(ctx),
        freeu=_freeu(j_fourier, mode))
    tu = torch_unet(params)
    with torch.no_grad():
        got = tu(torch.from_numpy(_nchw(x).copy()), 501,
                 torch.from_numpy(ctx), freeu=_freeu(t_fourier, mode))
        plain = tu(torch.from_numpy(_nchw(x).copy()), 501,
                   torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=1e-4,
                               rtol=1e-4)
    assert (got - plain).abs().max() > 1e-3


# ------------------------------------------------------------------ SAFREE
def test_svf_beta_f_beta_and_projection_match_jax():
    rs = np.random.RandomState(6)
    pair = rs.randn(2, 16, 32).astype(np.float32)
    e = rs.randn(32, 5).astype(np.float32)
    p_m = np.asarray(j_safree.projection_matrix(jnp.asarray(e)))
    p_c = np.asarray(j_safree.projection_matrix(jnp.asarray(e[:, :3])))
    want = j_safree.projection_and_orthogonal(
        jnp.asarray(pair), jnp.asarray(p_m), jnp.asarray(p_c))
    got = t_safree.projection_and_orthogonal(
        torch.from_numpy(pair), torch.from_numpy(p_m), torch.from_numpy(p_c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    mask = np.array([1] * 6 + [0] * 10)
    beta_j = j_safree.svf_beta(jnp.asarray(pair[1]), want[1],
                               jnp.asarray(mask))
    beta_t = t_safree.svf_beta(torch.from_numpy(pair[1]), got[1], mask)
    assert abs(beta_t - beta_j) <= 1e-6
    for z in (beta_t, 0.0, 0.4, 0.5333, 0.7, 1.2):
        for btype in ("sigmoid", "tanh"):
            for concept in ("nudity", "artists-VanGogh"):
                assert t_safree.f_beta(z, btype, 10, concept) == \
                    j_safree.f_beta(z, btype, 10, concept)


# ----------------------------------------------------------------- sampler
B_LAT = 8


def _jax_noise(rng, shape):
    def noise(i, salt):
        k = jax.random.fold_in(jax.random.fold_in(rng, i), salt)
        n = jax.random.normal(k, shape, dtype=jnp.float32)
        return torch.from_numpy(_nchw(n).copy())
    return noise


def test_sample_sd_lra_freeu_and_swap_match_jax():
    """4 DDPM steps on the tiny UNet and the JAX noise stream: the 3-way
    re-attention batch with the SafeGuard filters and SAFREE's per-step,
    per-sample context swap (sample 0 takes the alternative embeddings for
    steps 0-1, sample 1 for steps 0-2), at B = 2 (the filters read batch
    rows 1 and 2 in both packages). Tolerance as the loop parity: atol
    2e-3, rtol 1e-3; without the swap and FreeU the port's latents move
    by more than 1e-3."""
    model, params = jax_unet()
    tu = torch_unet(params)
    rs = np.random.RandomState(7)
    b, steps = 2, 4
    lat0 = rs.randn(b, B_LAT, B_LAT, 4).astype(np.float32)
    ctx = rs.randn(3, b, 5, 32).astype(np.float32)
    alt = rs.randn(3, b, 5, 32).astype(np.float32)
    use = np.stack([np.arange(steps) <= k for k in (1, 2)], 1)
    rng = jax.random.PRNGKey(11)
    want, _ = j_sampler.sample_sd(
        lambda lat, t, c, fu: model.apply(params, lat, t, c, freeu=fu),
        JDDPMScheduler(), jnp.asarray(ctx), jnp.asarray(lat0), rng, steps,
        guidance=j_sampler.GuidanceConfig(mode="lra"),
        text_embeds_alt=jnp.asarray(alt), use_alt_per_step=jnp.asarray(use),
        freeu=_freeu(j_fourier))
    args = (tu, DDPMScheduler(), torch.from_numpy(ctx),
            torch.from_numpy(_nchw(lat0).copy()),
            _jax_noise(rng, lat0.shape), steps)
    guidance = t_sampler.GuidanceConfig(mode="lra")
    with torch.no_grad():
        got, _ = t_sampler.sample_sd(
            *args, guidance=guidance, text_embeds_alt=torch.from_numpy(alt),
            use_alt_per_step=torch.from_numpy(use), freeu=_freeu(t_fourier))
        plain, _ = t_sampler.sample_sd(*args, guidance=guidance)
    np.testing.assert_allclose(got.numpy(), _nchw(want), atol=2e-3,
                               rtol=1e-3)
    assert (got - plain).abs().max() > 1e-3


# ---------------------------------------------------------------- pipeline
# erase id, safree_dict, SLD level, FreeU; the last case also runs the loop
# on both packages' embeddings
CASES = {
    "sld_rep": ("sld_rep", {}, "STRONG", False),
    "safree_rep+svf": ("safree_rep", {"safree": True, "svf": True}, None,
                       False),
    "std_rep+lra": ("std_rep", {"lra": True}, None, True),
    "safree_neg_prompt_rep_time+lra": (
        "safree_neg_prompt_rep_time",
        {"safree": True, "lra": True, "re_attn_t": [0, 1]}, None, True),
}
LOOP_CASE = "safree_neg_prompt_rep_time+lra"


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """The port's and the JAX package's SD-v1 pipelines on the same tiny
    f32 weights (UNet 32/64, VAE 32/64, a 2-layer CLIP over the tiny BPE
    vocabulary at 77 tokens)."""
    vocab = str(tmp_path_factory.mktemp("vocab"))
    chip_smoke.write_tiny_vocab(vocab)
    tok, jtok = (CLIPTokenizer.from_pretrained(vocab),
                 JCLIPTokenizer.from_pretrained(vocab))
    ckw = dict(vocab_size=max(tok.vocab.values()) + 1, hidden_size=32,
               num_layers=2, num_heads=2, max_position_embeddings=77,
               intermediate_size=64, eos_token_id=tok.eos_token_id)
    j_text = j_clip.CLIPTextModel(j_clip.CLIPTextConfig(**ckw))
    clip_params = random_params(j_text, 8, jax.random.PRNGKey(0),
                                jnp.zeros((1, 77), jnp.int32))
    j_unet_model, unet_params = jax_unet()
    j_vae_model, vae_params = jax_vae()
    cfg = t_clip.CLIPTextConfig(**ckw)
    mine = t_diffusion.SafeDiffusionPipeline(
        torch_unet(unet_params), torch_vae(vae_params),
        load(t_clip.CLIPTextModel(cfg), clip_params, cfg), tok,
        DDPMScheduler(), device="cpu")
    ref = j_diffusion.SafeDiffusionPipeline(
        j_unet_model, unet_params, j_vae_model, vae_params, j_text,
        clip_params, jtok, JDDPMScheduler())
    return mine, ref


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_erasure_matches_jax(pipes, case):
    """Each prompt's text through both pipelines (``_prepare_text``): the
    branch embeddings (atol 1e-4; SAFREE's projected ones 1e-3, through an
    ill-conditioned pseudo-inverse), the per-step swap table and the
    guidance config equal. For SAFREE with re-attention and FreeU, the
    4-step loop on those embeddings, the repellency window of the erase id
    and the JAX noise stream (atol 2e-3). Then the port's
    ``dispatch_batch`` gives complete images, and with FreeU the
    SafeGuard-without-re-attention check raises."""
    mine, ref = pipes
    erase_id, sf, level, with_freeu = CASES[case]
    sf = {**sf, "alpha": 0.01, "up_t": 10, "category": "nudity"}
    safe_config = None if level is None else t_diffusion.SLD_CONFIGS[level]
    space = list(NUDITY_NEGATIVE_PROMPT_SPACE)
    prompts, steps = ["a cat on a sofa", "the dog runs"], 4
    neg = ", ".join(space) if "neg_prompt" in erase_id else None
    per_t, per_j = [], []
    for p in prompts:
        with torch.no_grad():
            t = mine._prepare_text(p, neg, space, sf,
                                   t_diffusion.ERASE_SPECS[erase_id],
                                   safe_config, steps)
        j = ref._prepare_text(p, neg, space, sf,
                              j_diffusion.ERASE_SPECS[erase_id],
                              safe_config, steps, None)
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]),
                                   atol=1e-4)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                                   atol=1e-3 if sf.get("safree") else 1e-4)
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
        assert dataclasses.asdict(t[3]) == dataclasses.asdict(j[3])
        per_t.append(t)
        per_j.append(j)
    assert per_t[0][0].shape[0] == (2 if case == "safree_rep+svf" else 3)

    spec = t_diffusion.ERASE_SPECS[erase_id]
    window = dict(t_start=spec.window.t_start, t_end=spec.window.t_end)
    rkw = dict(sigma=30.0, scale=0.4, beta_threshold=1e-12)
    refs = np.random.RandomState(9).randn(5, 4, B_LAT, B_LAT).astype(
        np.float32)
    if case == LOOP_CASE:
        b = 1                      # the SafeGuard filters' batch layout
        lat0 = np.random.RandomState(8).randn(b, B_LAT, B_LAT, 4).astype(
            np.float32)
        rng = jax.random.PRNGKey(3)
        want, w_app = j_sampler.sample_sd(
            lambda lat, t, c, fu: ref.unet.apply(ref.unet_params, lat, t, c,
                                                 freeu=fu),
            ref.scheduler, per_j[0][0], jnp.asarray(lat0), rng, steps,
            guidance=per_j[0][3],
            repellency=j_methods.RepellencyConfig(**rkw),
            refs_nchw=jnp.asarray(refs),
            window=j_sampler.RepellencyWindow(**window),
            text_embeds_alt=per_j[0][1], use_alt_per_step=per_j[0][2],
            freeu=_freeu(j_fourier, "all"))
        with torch.no_grad():
            got, app = t_sampler.sample_sd(
                mine.unet, mine.scheduler, per_t[0][0],
                torch.from_numpy(_nchw(lat0).copy()),
                _jax_noise(rng, lat0.shape), steps, guidance=per_t[0][3],
                repellency=t_methods.RepellencyConfig(**rkw),
                refs=torch.from_numpy(refs),
                window=t_sampler.RepellencyWindow(**window),
                text_embeds_alt=per_t[0][1], use_alt_per_step=per_t[0][2],
                freeu=_freeu(t_fourier, "all"))
        np.testing.assert_array_equal(app.numpy(), np.asarray(w_app))
        np.testing.assert_allclose(got.numpy(), _nchw(want), atol=2e-3,
                                   rtol=1e-3)

    proc = t_methods.KernelFastRepellency(
        ref_data=torch.from_numpy(refs), embed_fn=lambda x: x, sigma=30.0,
        scale=0.4, beta_threshold=1e-12, device="cpu")
    kw = dict(num_inference_steps=steps, height=16, width=16,
              negative_prompt=neg, negative_prompt_space=space,
              repellency_processor=proc, erase_spec=spec, safree_dict=sf,
              safe_config=safe_config,
              freeu=_freeu(t_fourier, "all") if with_freeu else None)
    n = 1 if with_freeu else 2
    pending = mine.dispatch_batch(prompts[:n], [11, 12][:n],
                                  [7.5, 5.0][:n], **kw)
    images = pending.fetch()
    assert [im.shape for im in images] == [(16, 16, 3)] * n
    assert bool(torch.isfinite(pending.latents).all())
    if with_freeu:
        with pytest.raises(ValueError, match="re-attention"):
            mine.dispatch_batch(prompts[:1], [1], [7.5], **{
                **kw, "safree_dict": {**sf, "lra": False}})


# ------------------------------------------------------------------ runner
@pytest.mark.parametrize("extra,lines", [
    (["--erase_id", "sld_rep", "--safe_level", "MAX"],
     ["SLD safe level: MAX"]),
    (["--erase_id", "safree_rep", "--safree", "-svf"],
     ["we remove", "beta : "]),
    (["--erase_id", "std_rep", "-lra"], []),
    (["--erase_id", "safree_neg_prompt_rep_time", "--safree", "-lra"],
     ["we remove"]),
    (["--erase_id", "rece_rep"], [])],
    ids=["sld_rep", "safree_svf", "lra", "safree_lra_freeu", "rece_rep"])
def test_runner_runs_the_erasure_flags(assets, extra, lines):  # noqa: F811
    """The nudity runner with each SD-v1 erasure flag on the tiny
    checkpoint (2 cases, 3 steps, the bank and the gate): the output tree
    is complete and the methods' log lines are there (rece_rep samples as
    SLD with its default STRONG level: the level is logged only for ids
    that name sld, as in the JAX runner)."""
    save = assets.root / ("out_" + "_".join(extra).replace("-", ""))
    t_nudity.main(_argv(assets, save, "--valid_case_numbers", "0,2",
                        "--task_config", assets.task, "--nudenet-path",
                        assets.onnx, *extra))
    logs = (save / "logs.txt").read_text()
    assert logs.count("Wall-Clock Time for image generation") == 2
    for line in lines:
        assert line in logs, line
    assert sorted(p.name for p in (save / "all").glob("*.png")) == \
        ["0_sexual.png", "1_sexual.png"]
    assert (save / "detect_dict.json").exists()
