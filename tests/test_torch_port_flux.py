"""FLUX.1 in the port against the benchmark's plain f32 reference
(``benchmark/reference/flux_dit.py`` and ``flux.py``, written from the
equations and importing nothing of the port), on seeded random weights at a
tiny size on the CPU: 2 double and 2 single blocks, 2 heads of 32, a 16x16
latent (8x8 packed tokens), 8 text tokens, rotary axes (4, 14, 14). Also
the qk-RMSNorm + rotary plain form (``ops.qk_rope``) against a literal
complex-number rotary, the dynamic-shift schedule against its closed form
with SD3's schedule left bit-equal, FLUX's 2x2 packing, the strict load
under diffusers' names, and the tiny ``SafeFluxPipeline`` end to end
against the reference loop on the same noise.

No JAX: the JAX package has no FLUX.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from benchmark.harness.weights import draw_checkpoint
from benchmark.reference import flux as ref_flux
from benchmark.reference import flux_dit as ref_dit
from benchmark.reference import sample as ref_sample
from benchmark.reference.layers import Params
from safe_denoiser_tpu_torch.models import FluxConfig, FluxTransformer
from safe_denoiser_tpu_torch.models.flux import position_ids, rope_tables
from safe_denoiser_tpu_torch.models.weights import load_component_config
from safe_denoiser_tpu_torch.ops import qk_rope
from safe_denoiser_tpu_torch.pipeline.sampler import (pack_latents,
                                                      unpack_latents)
from safe_denoiser_tpu_torch.schedulers import (FlowMatchDynamicConfig,
                                                FlowMatchEulerScheduler,
                                                flow_match_config)

# the transformer as transformer/config.json names it, at the tiny size
TINY = {"in_channels": 64, "num_layers": 2, "num_single_layers": 2,
        "num_attention_heads": 2, "attention_head_dim": 32,
        "joint_attention_dim": 24, "pooled_projection_dim": 20,
        "guidance_embeds": True, "axes_dims_rope": [4, 14, 14]}
FLUX_SCHEDULER = {"num_train_timesteps": 1000, "shift": 3.0,
                  "use_dynamic_shifting": True, "base_shift": 0.5,
                  "max_shift": 1.15, "base_image_seq_len": 256,
                  "max_image_seq_len": 4096}


def _port(cfg=TINY):
    return FluxTransformer(FluxConfig(
        in_channels=cfg["in_channels"], num_layers=cfg["num_layers"],
        num_single_layers=cfg["num_single_layers"],
        num_heads=cfg["num_attention_heads"],
        head_dim=cfg["attention_head_dim"],
        joint_attention_dim=cfg["joint_attention_dim"],
        pooled_projection_dim=cfg["pooled_projection_dim"],
        guidance_embeds=cfg["guidance_embeds"],
        axes_dims_rope=tuple(cfg["axes_dims_rope"])))


def _weights(seed=3, cfg=TINY):
    """The reference's parameter table with seeded values: matrices and
    biases N(0, 0.2^2) (large enough that every block moves the stream),
    norm weights 1 + N(0, 0.1^2)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind, _ in ref_dit.param_spec(cfg):
        t = torch.randn(shape, generator=gen)
        out[name] = 1 + 0.1 * t if kind == "ones" else 0.2 * t
    return out


def test_strict_load_under_diffusers_names():
    """The reference's table (diffusers' ``FluxTransformer2DModel`` names)
    loads strictly; a missing or an extra name is refused."""
    sd = _weights()
    model = _port()
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    with pytest.raises(RuntimeError):
        _port().load_state_dict({k: v for k, v in sd.items()
                                 if k != "proj_out.bias"}, strict=True)
    with pytest.raises(RuntimeError):
        _port().load_state_dict({**sd, "pos_embed.proj.weight": sd[
            "proj_out.weight"]}, strict=True)


def test_config_from_transformer_config_json(tmp_path):
    """``load_component_config(dir, "flux")`` reads FLUX.1-dev's
    ``transformer/config.json``; patch size 1 only."""
    raw = {"_class_name": "FluxTransformer2DModel", "attention_head_dim": 128,
           "guidance_embeds": True, "in_channels": 64,
           "joint_attention_dim": 4096, "num_attention_heads": 24,
           "num_layers": 19, "num_single_layers": 38, "patch_size": 1,
           "pooled_projection_dim": 768, "axes_dims_rope": [16, 56, 56]}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    assert load_component_config(str(tmp_path), "flux") == FluxConfig()
    # every FLUX block RMS-norms q and k: a constant, not a field to set
    assert FluxConfig().qk_norm == "rms_norm"
    assert "qk_norm" not in {f.name for f in dataclasses.fields(FluxConfig)}
    (tmp_path / "config.json").write_text(json.dumps({**raw,
                                                      "patch_size": 2}))
    with pytest.raises(ValueError):
        load_component_config(str(tmp_path), "flux")


@pytest.mark.parametrize("guidance", [True, False])
def test_transformer_matches_the_reference_in_f32(guidance):
    """Port and reference on one seeded checkpoint, two batch rows at
    different sigmas and guidance: f32 round-off apart (rtol 2e-5 of the
    output's scale; the two take sums and the attention in other orders)."""
    cfg = dict(TINY, guidance_embeds=guidance)
    sd = _weights(cfg=cfg)
    model = _port(cfg)
    model.load_state_dict(sd, strict=True)
    gen = torch.Generator().manual_seed(5)
    lat = torch.randn(2, 16, 16, 16, generator=gen)
    ctx = torch.randn(2, 8, TINY["joint_attention_dim"], generator=gen)
    pooled = torch.randn(2, TINY["pooled_projection_dim"], generator=gen)
    sigma, g = torch.tensor([0.93, 0.41]), torch.tensor([3.5, 1.0])
    with torch.no_grad():
        got = model(pack_latents(lat), ctx, pooled, sigma,
                    g if guidance else None, grid=(8, 8))
        want = ref_dit.forward(Params(sd), cfg, ref_flux.pack(lat), sigma,
                               g, ctx, pooled, (8, 8))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64)
    assert want.std() > 0.1
    err = (got - want).abs().max().item()
    assert err <= 2e-5 * want.abs().max().item(), err


def test_tensor_parallel_flux_refuses_to_run():
    """``shard_params_tp`` takes the double blocks' attention (its names
    match ``MMDIT_TP_RULES``), but the tensor-parallel joint attention
    applies no rotary and joins the streams in SD3's order: the sharded
    model raises instead of returning a wrong velocity."""
    from safe_denoiser_tpu_torch.parallel import make_mesh, shard_params_tp
    model = _port()
    model.load_state_dict(_weights(), strict=True)
    shard_params_tp(model, make_mesh(devices=["cpu"] * 2, axis="model"))
    assert all(b.attn._tp is not None for b in model.transformer_blocks)
    gen = torch.Generator().manual_seed(5)
    lat = torch.randn(1, 16, 16, 16, generator=gen)
    ctx = torch.randn(1, 8, TINY["joint_attention_dim"], generator=gen)
    pooled = torch.randn(1, TINY["pooled_projection_dim"], generator=gen)
    with torch.no_grad(), pytest.raises(NotImplementedError):
        model(pack_latents(lat), ctx, pooled, 0.5, 3.5, grid=(8, 8))


def test_flux_pipeline_refuses_the_parallel_layer():
    """The SD3 pipeline's mesh modes and LoRA merge are not FLUX's."""
    from safe_denoiser_tpu_torch.pipeline.diffusion_flux import \
        SafeFluxPipeline
    pipe = SafeFluxPipeline.__new__(SafeFluxPipeline)
    with pytest.raises(NotImplementedError):
        pipe.enable_data_mesh(2)
    with pytest.raises(NotImplementedError):
        pipe.enable_bank_sharding(None)
    assert not hasattr(pipe, "load_lora")


def test_qk_rope_plain_form_is_the_complex_rotary():
    """``rms_rope_ref`` against the literal form: the RMS-normed head as
    complex numbers a + ib of adjacent pairs, times e^(i theta) with theta
    = position x frequency per axis (FLUX's FluxPosEmbed), in f64; the
    plain form in f64 agrees to 1e-12."""
    gen = torch.Generator().manual_seed(7)
    txt, gh, gw, axes = 3, 4, 5, (4, 14, 14)
    s = txt + gh * gw
    x = torch.randn(2, s, 3, 32, generator=gen, dtype=torch.float64)
    w = 1 + 0.1 * torch.randn(32, generator=gen, dtype=torch.float64)
    ids = position_ids(txt, gh, gw)
    cos, sin = rope_tables(ids, axes)
    got = qk_rope.rms_rope_ref(x, w, torch.from_numpy(cos).double(),
                               torch.from_numpy(sin).double())
    y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * w
    theta = np.concatenate([np.outer(ids[:, i], 10000.0 ** (
        -np.arange(0, d, 2) / d)) for i, d in enumerate(axes)], 1)
    z = torch.view_as_complex(y.reshape(2, s, 3, 16, 2).contiguous())
    rot = torch.polar(torch.ones(s, 16, dtype=torch.float64),
                      torch.from_numpy(theta))[:, None]
    want = torch.view_as_real(z * rot).reshape(2, s, 3, 32)
    # cos and sin come from f32 tables: 6e-8 of an entry
    assert (got - want).abs().max().item() <= 1e-6
    got64 = qk_rope.rms_rope_ref(x, w, torch.from_numpy(np.cos(np.repeat(
        theta, 2, 1))), torch.from_numpy(np.sin(np.repeat(theta, 2, 1))))
    assert (got64 - want).abs().max().item() <= 1e-12


def test_position_ids_and_tables():
    """Text (0, 0, 0), image (0, row, col) row-major; at position 0 every
    angle is 0 (cos 1, sin 0)."""
    ids = position_ids(2, 3, 4)
    assert ids.shape == (14, 3) and ids.dtype == np.float32
    assert not ids[:2].any() and (ids[2:, 0] == 0).all()
    assert ids[2 + 4 * 2 + 3].tolist() == [0, 2, 3]
    cos, sin = rope_tables(ids, (4, 14, 14))
    assert cos.shape == sin.shape == (14, 32) and cos.dtype == np.float32
    assert (cos[:3] == 1).all() and (sin[:3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qk_rope_plain_joins_segments(dtype):
    """Two segments: each normed and rotated at its own positions of the
    joint sequence, then joined (v too); one segment: its own v back, no
    copy. bf16 rounds once from the f32 computation."""
    gen = torch.Generator().manual_seed(8)
    cos, sin = (torch.from_numpy(t) for t in rope_tables(
        position_ids(3, 2, 4), (4, 14, 14)))

    def seg(n):
        return tuple(torch.randn(2, n, 2, 32, generator=gen).to(dtype)
                     for _ in range(3)) + tuple(
            (1 + 0.1 * torch.randn(32, generator=gen)).to(dtype)
            for _ in range(2))

    a, b = seg(3), seg(8)
    q, k, v = qk_rope.qk_rope([a, b], cos, sin)
    assert q.shape == (2, 11, 2, 32) and q.dtype == dtype
    assert torch.equal(q[:, :3], qk_rope.rms_rope_ref(a[0], a[3], cos[:3],
                                                      sin[:3]))
    assert torch.equal(k[:, 3:], qk_rope.rms_rope_ref(b[1], b[4], cos[3:],
                                                      sin[3:]))
    assert torch.equal(v, torch.cat([a[2], b[2]], 1))
    one = seg(11)
    q1, _, v1 = qk_rope.qk_rope([one], cos, sin)
    assert v1 is one[2]
    want = qk_rope.rms_rope_ref(one[0].float(), one[3], cos, sin)
    assert ((q1.float() - want).abs() <= 2 ** -7 * want.abs() + 1e-6).all()


def test_dynamic_shift_schedule_closed_form():
    """FLUX.1-dev at 1024^2 (4096 image tokens): mu 1.15, sigmas
    e^mu / (e^mu + 1/s - 1) over s = linspace(1, 1/28, 28), timesteps 1000
    sigma, a final sigma 0; 14 of the 28 timesteps in [780, 1000]; mu
    linear between (256, 0.5) and (4096, 1.15); the reference's own
    schedule the same."""
    assert isinstance(flow_match_config(FLUX_SCHEDULER),
                      FlowMatchDynamicConfig)
    sch = FlowMatchEulerScheduler(flow_match_config(FLUX_SCHEDULER))
    assert sch.mu(4096) == pytest.approx(1.15, abs=1e-12)
    assert sch.mu(256) == pytest.approx(0.5, abs=1e-12)
    assert sch.mu(1024) == pytest.approx(0.5 + 0.65 * 768 / 3840, abs=1e-12)
    ts, sig = sch.timesteps_and_sigmas(28, image_seq_len=4096)
    s = np.linspace(1, 1 / 28, 28)
    want = math.exp(1.15) / (math.exp(1.15) + 1 / s - 1)
    np.testing.assert_allclose(sig[:-1], want.astype(np.float32), rtol=0,
                               atol=0)
    assert sig[-1] == 0 and sig.dtype == ts.dtype == np.float32
    np.testing.assert_array_equal(ts, (want * 1000).astype(np.float32))
    assert sum(780 <= t <= 1000 for t in ts) == 14
    r_ts, r_sig = ref_flux.schedule(FLUX_SCHEDULER, 28, 4096)
    np.testing.assert_allclose(r_sig, sig, rtol=1e-7)
    np.testing.assert_allclose(r_ts, ts, rtol=1e-7)
    with pytest.raises(ValueError):
        sch.timesteps_and_sigmas(28)


@pytest.mark.parametrize("steps", [10, 50])
def test_sd3_schedule_is_left_bit_equal(steps):
    """Without dynamic shifting the table is SD3's shifted linspace, bit
    for bit as before the dynamic shift existed, with or without a token
    count."""
    sch = FlowMatchEulerScheduler()
    n = 1000
    shift = lambda x: 3.0 * x / (1 + 2.0 * x)  # noqa: E731
    sig_all = shift(np.linspace(1, n, n, dtype=np.float64)[::-1] / n)
    lin = np.linspace(float(sig_all[0]) * n, float(sig_all[-1]) * n, steps,
                      dtype=np.float64)
    sig = shift(lin / n)
    for got_ts, got_sig in (sch.timesteps_and_sigmas(steps),
                            sch.timesteps_and_sigmas(steps, 4096)):
        np.testing.assert_array_equal(got_ts, (sig * n).astype(np.float32))
        np.testing.assert_array_equal(
            got_sig, np.concatenate([sig, [0.0]]).astype(np.float32))


def test_pack_unpack_round_trip():
    """diffusers' ``_pack_latents`` order: token (i, j) of the 2x2 grid
    holds channel c's patch values (dy, dx) at 4c + 2dy + dx; unpack
    inverts it; the reference packs the same."""
    lat = torch.randn(2, 16, 6, 10)
    packed = pack_latents(lat)
    assert packed.shape == (2, 15, 64)
    b, c, i, j, dy, dx = 1, 5, 2, 3, 1, 0
    assert packed[b, i * 5 + j, 4 * c + 2 * dy + dx] == lat[b, c, 2 * i + dy,
                                                            2 * j + dx]
    assert torch.equal(unpack_latents(packed, 6, 10), lat)
    assert torch.equal(ref_flux.pack(lat), packed)
    assert torch.equal(ref_flux.unpack(packed, 6, 10), lat)


def _tiny_config(dtype="float32"):
    """benchmark/configs/flux1-dev.json cut to the tiny size (every width
    of every component)."""
    from benchmark.harness.spec import BENCH
    cfg = json.loads((BENCH / "configs/flux1-dev.json").read_text())
    c = cfg["components"]
    cfg["max_sequence_length"] = 8
    c["transformer"].update(TINY, joint_attention_dim=32,
                            pooled_projection_dim=32)
    c["text_encoder"].update(hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=2, intermediate_size=64,
                             vocab_size=600, projection_dim=32)
    c["text_encoder_2"].update(d_model=32, d_kv=16, d_ff=64, num_layers=2,
                               num_heads=2, vocab_size=600)
    c["vae"].update(block_out_channels=[32, 64], layers_per_block=1,
                    norm_num_groups=8)
    for comp in c.values():
        comp["dtype"] = dtype
    return cfg


def test_tiny_pipeline_matches_the_reference_loop():
    """``SafeFluxPipeline`` (the benchmark's flux family builds it from a
    seeded checkpoint) against the reference's text, loop and decode on
    the same checkpoint, bank and noise stream: 6 steps at 32^2 (16x16
    latents), kernel_fast renoising on the steps in [1000, 500]. In f32
    the text states and latents agree to 1e-5 of their spread, the uint8
    images within one level."""
    from benchmark.harness.families.flux import System
    from benchmark.harness.families.common import draw_bank

    cfg = _tiny_config()
    recipe = {"kind": "batch", "batch": 1, "height": 32, "width": 32,
              "steps": 6, "sampler": "flow_match", "guidance": [3.5],
              "repellency": {"method": "kernel_fast", "bank_rows": 4,
                             "sigma": 1.0, "scale": 0.5,
                             "window": [1000.0, 500.0], "beta_gate": False}}
    seed = 2 ** 31 + 5
    system = System(cfg, recipe, seed, "cpu")
    prompt, row_seed = "a red boat on a lake", 1234
    pending = system.pipe.dispatch_batch([prompt], [row_seed], [3.5],
                                         **system.dispatch_kwargs())
    image = pending.fetch()[0]
    assert bool(pending.applied.any())
    tensors = draw_checkpoint(cfg, seed, "cpu")
    bank = draw_bank(cfg, recipe, seed, "cpu")
    with torch.no_grad():
        text = ref_sample.text("flux", tensors, cfg, recipe, prompt,
                               device="cpu")
        lat = ref_sample.loop("flux", tensors, cfg, recipe, text, row_seed,
                              3.5, bank, device="cpu")
        want = ref_sample.decode(tensors, cfg, lat)[0].numpy()
    t5, pooled = system.pipe.encode_prompt(prompt)
    for got, ref in ((t5, text["t5"]), (pooled, text["pooled"])):
        assert (got - ref).abs().max() <= 1e-5 * ref.std()
    got = pending.latents
    assert (got - lat).abs().max() <= 1e-5 * lat.std()
    assert np.abs(image.astype(int) - want.astype(int)).max() <= 1


def test_from_pretrained_reads_a_flux_checkpoint(tmp_path):
    """A tiny HF-layout FLUX.1 checkpoint (transformer/, vae/,
    text_encoder/ (CLIP-L), text_encoder_2/ (T5), the two tokenizer dirs,
    scheduler/ with the dynamic shift) written from a seeded pipeline:
    ``SafeFluxPipeline.from_pretrained`` loads every component strictly,
    reads the dynamic-shift scheduler, and gives the same image."""
    import dataclasses

    from benchmark.harness.families.flux import System
    from safe_denoiser_tpu_torch.models.weights import save_safetensors
    from safe_denoiser_tpu_torch.pipeline.diffusion_flux import \
        SafeFluxPipeline

    cfg = _tiny_config()
    recipe = {"sampler": "flow_match", "batch": 1, "height": 32,
              "width": 32, "steps": 3,
              "repellency": {"method": "kernel_fast", "bank_rows": 4,
                             "sigma": 1.0, "scale": 0.5,
                             "window": [1000.0, 500.0], "beta_gate": False}}
    cfg["scheduler"] = FLUX_SCHEDULER
    pipe = System(cfg, recipe, 11, "cpu").pipe
    c = pipe.clip_l.config
    parts = {
        "transformer": (pipe.transformer, dict(
            cfg["components"]["transformer"], patch_size=1)),
        "vae": (pipe.vae, dataclasses.asdict(pipe.vae.config)),
        "text_encoder": (pipe.clip_l, dict(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
            max_position_embeddings=c.max_position_embeddings,
            intermediate_size=c.intermediate_size, hidden_act=c.hidden_act,
            projection_dim=c.projection_dim, eos_token_id=c.eos_token_id)),
        "text_encoder_2": (pipe.t5, dataclasses.asdict(pipe.t5.config))}
    for sub, (module, config) in parts.items():
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "config.json").write_text(json.dumps(config))
        save_safetensors(str(tmp_path / sub / "model.safetensors"),
                         module.state_dict())
    for sub in ("tokenizer", "tokenizer_2"):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "vocab.json").write_text(json.dumps(
            pipe.tokenizer.vocab))
        (tmp_path / sub / "merges.txt").write_text("#version: 0.2\n")
    (tmp_path / "scheduler").mkdir()
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(
        json.dumps(FLUX_SCHEDULER))
    loaded = SafeFluxPipeline.from_pretrained(str(tmp_path), device="cpu",
                                              dtype=torch.float32)
    loaded.max_sequence_length = pipe.max_sequence_length
    assert isinstance(loaded.scheduler.config, FlowMatchDynamicConfig)
    args = (["a small boat"], [5], [3.5])
    kw = dict(num_inference_steps=3, height=32, width=32)
    want = pipe.generate_batch(*args, **kw)[0]
    got = loaded.generate_batch(*args, **kw)[0]
    assert np.array_equal(got, want)
