"""The port's graphed sampling programs (pipeline/graph.py) on the CPU.

A pipeline's ``_batch_inputs`` gives the loop body that the card captures
into one CUDA graph, with its static input buffers; on the CPU the same
body runs eagerly on the same buffers. Here that body, its noise buffer
filled with the JAX package's threefry stream in the loop's order of
draws (``graph.noise_slots``), is held against the JAX package's
``sample_sd`` / ``sample_sd3`` (tolerances of tests/test_torch_port_
sampler.py: f32 sums in another order, amplified over the steps), across
tests/test_loop_parity.py's matrix of erase shapes and schedulers, SPELL's
sparse force, and SAFREE's swap with two prompts whose rows differ. The
same body is held bit for bit against the loop as it ran before the
repairs for capture (a Python timestep per step, SAFREE's swap behind a
host branch; ``_old_sample_sd`` below), and ``dispatch_batch``'s
pre-drawn noise against the draws the old loop made step by step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from safe_denoiser_tpu.pipeline import sampler as j_sampler
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu.schedulers import DDIMConfig as JDDIMConfig
from safe_denoiser_tpu.schedulers import DDIMScheduler as JDDIMScheduler
from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPMScheduler
from safe_denoiser_tpu.schedulers import flow_match as j_fm
from safe_denoiser_tpu_torch.models import CLIPTextConfig, CLIPTextModel
from safe_denoiser_tpu_torch.pipeline import graph
from safe_denoiser_tpu_torch.pipeline import sampler as t_sampler
from safe_denoiser_tpu_torch.pipeline.diffusion import (
    EraseSpec, GuidanceConfig, RepellencyWindow, SafeDiffusionPipeline)
from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
    SafeDiffusion3Pipeline
from safe_denoiser_tpu_torch.repellency import (KernelFastRepellency,
                                                RepellencyConfig)
from safe_denoiser_tpu_torch.repellency.methods import apply_repellency
from safe_denoiser_tpu_torch.schedulers import (DDIMConfig, DDIMScheduler,
                                                DDPMScheduler)
from safe_denoiser_tpu_torch.schedulers import flow_match as t_fm
from safe_denoiser_tpu_torch.text import CLIPTokenizer
from tests.test_torch_port_models import (jax_unet, jax_vae, torch_unet,
                                          torch_vae)
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401
from tests.test_torch_port_sd3 import jax_mmdit, torch_mmdit

B, H_LAT, STEPS = 2, 8, 5
SIDE = 2 * H_LAT            # the tiny VAE's scale factor is 2
RNG = jax.random.PRNGKey(1234)
SIGMA, SCALE = 30.0, 0.4
PROMPTS = ["a cat on a sofa", "the dog runs"]


def _jax_noise(i: int, salt: int) -> torch.Tensor:
    k = jax.random.fold_in(jax.random.fold_in(RNG, i), salt)
    n = jax.random.normal(k, (B, H_LAT, H_LAT, 4), dtype=jnp.float32)
    return torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())


def _old_sample_sd(unet_fn, scheduler, text_embeds, latents, noise_fn,
                   num_inference_steps, guidance, repellency=None, refs=None,
                   window=RepellencyWindow(), guidance_scale=None,
                   text_embeds_alt=None, use_alt_per_step=None):
    """The port's SD-v1 loop before the repairs for capture: the UNet took
    each step's timestep as a Python int, and SAFREE's swap ran behind a
    host branch on the step's mask."""
    timesteps = scheduler.timesteps(num_inference_steps)
    n_br, b = text_embeds.shape[0], text_embeds.shape[1]
    ctx = text_embeds.reshape(n_br * b, *text_embeds.shape[2:])
    swap = None
    if text_embeds_alt is not None and use_alt_per_step is not None:
        use = torch.as_tensor(use_alt_per_step, dtype=torch.bool)
        if use.dim() == 1:
            use = use[:, None].expand(num_inference_steps, b)
        swap = (text_embeds_alt.reshape(ctx.shape), use.cpu())
    momentum = torch.zeros_like(latents)
    applied = torch.zeros((num_inference_steps, b), dtype=torch.bool)
    for i, t in enumerate(int(t) for t in timesteps):
        latent_in = scheduler.scale_model_input(
            torch.cat([latents] * n_br, dim=0), t)
        step_ctx = ctx
        if swap is not None and bool(swap[1][i].any()):
            rows = swap[1][i].repeat(n_br)
            step_ctx = torch.where(rows[:, None, None], swap[0], ctx)
        eps = unet_fn(latent_in, t, step_ctx)
        eps = eps.reshape(n_br, b, *eps.shape[1:])
        eps, momentum = t_sampler._combine_guidance(eps, i, guidance,
                                                    momentum, guidance_scale)
        if repellency is not None and window.mask(i, t):
            x0 = scheduler.pred_original_sample(eps, t, latents)
            x0 = x0[0] if isinstance(x0, tuple) else x0
            x0_rep, is_neg = apply_repellency(x0, refs, repellency)
            renoised = scheduler.add_noise(x0_rep, noise_fn(i, 1), t)
            latents = torch.where(is_neg[:, None, None, None], renoised,
                                  latents)
            applied[i] = is_neg
        latents, _ = scheduler.step(eps, t, latents, num_inference_steps,
                                    noise=noise_fn(i, 2))
    return latents, applied


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab")
    chip_smoke.write_tiny_vocab(str(path))
    return str(path)


@pytest.fixture(scope="module")
def sd_pipe(vocab):
    """The JAX tests' tiny UNet and VAE in the port's pipeline, with a
    random tiny CLIP text tower (f32, CPU)."""
    tok = CLIPTokenizer.from_pretrained(vocab, max_length=16)
    torch.manual_seed(4)
    text = CLIPTextModel(CLIPTextConfig(
        vocab_size=max(tok.vocab.values()) + 1, hidden_size=32, num_layers=2,
        num_heads=2, max_position_embeddings=16, intermediate_size=64,
        eos_token_id=tok.eos_token_id))
    return SafeDiffusionPipeline(torch_unet(jax_unet()[1]),
                                 torch_vae(jax_vae()[1]), text, tok,
                                 DDPMScheduler(), device="cpu")


def _inputs(seed=5, n_br=3):
    rs = np.random.RandomState(seed)
    lat0 = rs.randn(B, 4, H_LAT, H_LAT).astype(np.float32)
    ctx = rs.randn(n_br, B, 5, 32).astype(np.float32)
    refs = rs.randn(8, 4, H_LAT, H_LAT).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    return lat0, ctx, refs


def _inject(bufs, in_window, step_noise=True, noise=_jax_noise):
    """Fill the noise buffer with ``noise`` in the loop's order of draws."""
    slots = graph.noise_slots(in_window, step_noise)
    assert len(slots) == bufs["noise"].shape[0]
    for (i, salt), row in slots.items():
        bufs["noise"][row] = noise(i, salt)


def _in_window(sched, rep_cfg, window):
    return [rep_cfg is not None and window.mask(i, int(t))
            for i, t in enumerate(sched.timesteps(STEPS))]


# erase shape (tests/test_loop_parity.py's matrix, plus SPELL): guidance
# mode, repellency method, window
MATRIX = {
    "std": ("cfg", None, None),
    "std_rep": ("cfg", "kernel_fast", (1000.0, 300.0)),
    "safe_denoiser": ("cfg", "kernel_fast", (1000.0, 780.0)),
    "sld": ("sld", None, None),
    "sld_rep_time": ("sld", "kernel_fast", (1000.0, 300.0)),
    "spell": ("cfg", "sparse", (1000.0, 300.0)),
}
REP_KW = {"kernel_fast": dict(sigma=SIGMA, scale=SCALE, epsilon=1e-8,
                              beta_threshold=1e-12, use_beta_gate=True),
          # a radius past every distance of these latents, so the sparse
          # force acts on every row; a scale that keeps it finite
          "sparse": dict(radius=400.0, scale=2e-4)}


@pytest.mark.parametrize("erase,scheduler_kind", [
    (erase, kind) for erase in MATRIX for kind in ("ddpm", "ddim")
    if (erase, kind) != ("spell", "ddim")])
def test_graph_body_matches_jax_and_the_old_loop(sd_pipe, erase,
                                                 scheduler_kind):
    mode, method, win = MATRIX[erase]
    lat0, ctx3, refs = _inputs()
    guidance = GuidanceConfig(mode=mode, sld_warmup_steps=2)
    n_br = guidance.branches
    window = RepellencyWindow(*win) if win else RepellencyWindow()
    rep = (None if method is None
           else RepellencyConfig(method=method, **REP_KW[method]))
    if scheduler_kind == "ddpm":
        j_sched, sched = JDDPMScheduler(), DDPMScheduler()
    else:
        j_sched, sched = JDDIMScheduler(JDDIMConfig()), \
            DDIMScheduler(DDIMConfig())
    pipe = SafeDiffusionPipeline(sd_pipe.unet, sd_pipe.vae,
                                 sd_pipe.text_encoder, sd_pipe.tokenizer,
                                 sched, device="cpu")
    text = torch.from_numpy(ctx3[:n_br])
    program, bufs = pipe._batch_inputs(
        text, None, None, [0] * B, [7.5] * B, STEPS, SIDE, SIDE, guidance,
        rep, None if rep is None else torch.from_numpy(refs), window, None)
    bufs["latents"] = torch.from_numpy(lat0)
    _inject(bufs, _in_window(sched, rep, window))
    with torch.no_grad():
        got, applied = program.loop(bufs)
        old, old_applied = _old_sample_sd(
            pipe.unet, sched, text, torch.from_numpy(lat0), _jax_noise,
            STEPS, guidance, rep, None if rep is None
            else torch.from_numpy(refs), window, guidance_scale=bufs["gs"])
    assert torch.equal(got, old) and torch.equal(applied, old_applied)

    model, params = jax_unet()
    want, w_applied = j_sampler.sample_sd(
        lambda lat, t, c, fu: model.apply(params, lat, t, c), j_sched,
        jnp.asarray(ctx3[:n_br]), jnp.asarray(lat0.transpose(0, 2, 3, 1)),
        RNG, STEPS, guidance=j_sampler.GuidanceConfig(
            mode=mode, sld_warmup_steps=2),
        repellency=(None if rep is None else j_methods.RepellencyConfig(
            method=method, **REP_KW[method])),
        refs_nchw=None if rep is None else jnp.asarray(refs),
        window=j_sampler.RepellencyWindow(*win) if win
        else j_sampler.RepellencyWindow())
    if rep is not None:
        assert applied.any() and not applied.all(), applied
    np.testing.assert_array_equal(applied.numpy(), np.asarray(w_applied))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=2e-3, rtol=1e-3)


def test_graph_body_safree_rows_differ(sd_pipe):
    """SAFREE's per-sample window with two prompts whose rows differ
    (steps 0-1 against 0-3 on the alternative embeddings), with
    kernel_fast in [1000, 300]: every step selects on the device, equal to
    the old host-branched swap bit for bit and to the JAX scan."""
    lat0, ctx, refs = _inputs(seed=6, n_br=2)
    alt = np.random.RandomState(7).randn(*ctx.shape).astype(np.float32)
    steps = np.arange(STEPS)
    use = np.stack([steps < 2, steps < 4], axis=1)            # [S, B]
    rep = RepellencyConfig(**REP_KW["kernel_fast"])
    window = RepellencyWindow(1000.0, 300.0)
    guidance = GuidanceConfig()
    program, bufs = sd_pipe._batch_inputs(
        torch.from_numpy(ctx), torch.from_numpy(alt), torch.from_numpy(use),
        [0] * B, [7.5] * B, STEPS, SIDE, SIDE, guidance, rep,
        torch.from_numpy(refs), window, None)
    assert bufs["use_alt"].shape == (STEPS, B)
    bufs["latents"] = torch.from_numpy(lat0)
    _inject(bufs, _in_window(sd_pipe.scheduler, rep, window))
    with torch.no_grad():
        got, applied = program.loop(bufs)
        old, _ = _old_sample_sd(
            sd_pipe.unet, sd_pipe.scheduler, torch.from_numpy(ctx),
            torch.from_numpy(lat0), _jax_noise, STEPS, guidance, rep,
            torch.from_numpy(refs), window, guidance_scale=bufs["gs"],
            text_embeds_alt=torch.from_numpy(alt),
            use_alt_per_step=torch.from_numpy(use))
        plain, _ = program.loop({**bufs, "use_alt": torch.zeros_like(
            bufs["use_alt"])})
    assert torch.equal(got, old)
    assert (got - plain).abs().amax(dim=(1, 2, 3)).min() > 1e-3

    model, params = jax_unet()
    want, _ = j_sampler.sample_sd(
        lambda lat, t, c, fu: model.apply(params, lat, t, c),
        JDDPMScheduler(), jnp.asarray(ctx),
        jnp.asarray(lat0.transpose(0, 2, 3, 1)), RNG, STEPS,
        repellency=j_methods.RepellencyConfig(**REP_KW["kernel_fast"]),
        refs_nchw=jnp.asarray(refs),
        window=j_sampler.RepellencyWindow(1000.0, 300.0),
        text_embeds_alt=jnp.asarray(alt), use_alt_per_step=jnp.asarray(use))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("use_rep", [False, True], ids=["std", "rep"])
def test_graph_body_sd3_matches_jax(use_rep):
    """The SD3 flow-match body on its buffers (renoise draws inside the
    window only) against the JAX scan, six steps, CFG 2.5 as per-sample
    scales, kernel_fast with channel-normalized x in [1000, 500]; and bit
    for bit against ``sample_sd3`` drawing step by step."""
    from safe_denoiser_tpu.pipeline.sampler import RepellencyWindow as JWin
    from safe_denoiser_tpu.pipeline.sampler import sample_sd3 as j_sample
    from safe_denoiser_tpu.repellency import RepellencyConfig as JRep
    from tests.test_torch_port_sd3 import _loop_inputs

    steps, b, hw = 6, 2, 8
    rng = jax.random.PRNGKey(77)
    model, params = jax_mmdit()
    tf = torch_mmdit(params)
    lat0, ctx, pooled, refs = _loop_inputs()
    lat0 = np.ascontiguousarray(lat0.transpose(0, 3, 1, 2))
    rkw = dict(method="kernel_fast", sigma=10.0, scale=0.05,
               use_beta_gate=False, normalize_x=True)
    rep = RepellencyConfig(**rkw) if use_rep else None
    window = RepellencyWindow(1000.0, 500.0)
    sched = t_fm.FlowMatchEulerScheduler()
    vae = torch_vae(jax_vae()[1])
    pipe = SafeDiffusion3Pipeline(tf, vae, vae, vae, vae, None, None, None,
                                  sched, device="cpu")

    def noise(i, salt):
        k = jax.random.fold_in(jax.random.fold_in(rng, i), salt)
        n = jax.random.normal(k, (b, hw, hw, 4), dtype=jnp.float32)
        return torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())

    program, bufs = pipe._batch_inputs(
        torch.from_numpy(ctx), torch.from_numpy(pooled), [0] * b, [2.5] * b,
        steps, 2 * hw, 2 * hw, rep,
        torch.from_numpy(refs) if use_rep else None, window)
    ts, _ = sched.timesteps_and_sigmas(steps)
    in_window = [use_rep and window.mask(i, float(t))
                 for i, t in enumerate(ts)]
    bufs["latents"] = torch.from_numpy(lat0)
    _inject(bufs, in_window, step_noise=False, noise=noise)
    with torch.no_grad():
        got, app = program.loop(bufs)
        old, old_app = t_sampler.sample_sd3(
            tf, sched, torch.from_numpy(ctx), torch.from_numpy(pooled),
            torch.from_numpy(lat0), noise, steps, guidance_scale=bufs["gs"],
            repellency=rep, refs=torch.from_numpy(refs) if use_rep else None,
            window=window)
    assert torch.equal(got, old) and torch.equal(app, old_app)
    want, want_app = j_sample(
        lambda lat, t, c, p: model.apply(params, lat, t, c, p),
        j_fm.FlowMatchEulerScheduler(), jnp.asarray(ctx),
        jnp.asarray(pooled), jnp.asarray(lat0.transpose(0, 2, 3, 1)), rng,
        steps, guidance_scale=2.5,
        repellency=JRep(**rkw) if use_rep else None,
        refs_nchw=jnp.asarray(refs) if use_rep else None,
        window=JWin(1000.0, 500.0))
    np.testing.assert_array_equal(app.numpy(), np.asarray(want_app))
    if use_rep:
        assert app.any() and not app.all()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=2e-3, rtol=1e-3)


def test_dispatch_draws_the_old_loops_noise(sd_pipe):
    """``dispatch_batch`` draws all noise before the loop (the graph's
    buffer); its latents equal, bit for bit, the old loop's, which drew
    each step's renoise and step noise from the per-row generators as it
    went."""
    bank = torch.randn(5, 4, H_LAT, H_LAT,
                       generator=torch.Generator().manual_seed(0))
    proc = KernelFastRepellency(ref_data=bank, embed_fn=lambda x: x,
                                sigma=SIGMA, scale=0.3, beta_threshold=1e-12,
                                device="cpu")
    window = RepellencyWindow(1000.0, 300.0)
    seeds, gs = [11, 12], [7.5, 5.0]
    pending = sd_pipe.dispatch_batch(
        PROMPTS, seeds, gs, num_inference_steps=STEPS, height=SIDE,
        width=SIDE, repellency_processor=proc,
        erase_spec=EraseSpec(repellency=True, window=window))
    gens = [torch.Generator().manual_seed(s) for s in seeds]

    def draw():
        return torch.stack([torch.randn((4, H_LAT, H_LAT), generator=g)
                            for g in gens])

    with torch.no_grad():
        text = torch.cat([sd_pipe.encode_prompt(p) for p in PROMPTS], dim=1)
        old, old_applied = _old_sample_sd(
            sd_pipe.unet, sd_pipe.scheduler, text, draw(),
            lambda i, salt: draw(), STEPS, GuidanceConfig(),
            proc.config(), proc.get_proj_ref(), window,
            guidance_scale=torch.tensor(gs))
    assert pending.applied[:3].all() and not pending.applied[3:].any()
    assert torch.equal(pending.latents, old)
    assert torch.equal(pending.applied, old_applied)


def test_noise_slots_follow_the_loops_order():
    assert graph.noise_slots([True, False, True], step_noise=True) == {
        (0, 1): 0, (0, 2): 1, (1, 2): 2, (2, 1): 3, (2, 2): 4}
    assert graph.noise_slots([False, True, True], step_noise=False) == {
        (1, 1): 0, (2, 1): 1}
    assert graph.warm_step([False, True, True]) == 1
    assert graph.warm_step([False, False]) == 0


def test_graph_slot_runs_the_cpu_eagerly(sd_pipe, monkeypatch):
    """On the CPU the slot runs the body on the given buffers and keeps no
    graph; the keys carry the statics and the wrappers' switches."""
    program, bufs = sd_pipe._prepare_batch(PROMPTS, [1, 2], [7.5, 7.5],
                                           num_inference_steps=2,
                                           height=SIDE, width=SIDE)
    slot, marks = graph.GraphSlot(), []
    lat, applied, image = slot.run(program, bufs, marks.append)
    assert marks == ["loop", "decode"] and slot._captured is None
    want = graph._run_eager(program, bufs)
    assert torch.equal(lat, want[0]) and torch.equal(image, want[2])
    assert image.shape == (B, 3, SIDE, SIDE) and not applied.any()
    other, _ = sd_pipe._prepare_batch(PROMPTS, [1, 2], [7.5, 7.5],
                                      num_inference_steps=3, height=SIDE,
                                      width=SIDE)
    assert other.key != program.key
    before = graph.env_key()
    monkeypatch.setenv("SDT_FLASH2_LAYOUT", "nt")
    assert graph.env_key() != before
    assert set(graph.ENV_SWITCHES) >= {"SDT_INT8_ATTN", "SDT_UP_FORM",
                                       "SDT_FUSED_GN", "SDT_GN_STATS_MIN"}
