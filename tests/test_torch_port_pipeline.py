"""The port's slice as a whole against the JAX package, the pipeline object
on a fabricated HF-layout checkpoint, the device rule, and the port's
isolation from JAX -- all on the CPU.
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from safe_denoiser_tpu.models import AutoencoderKL as JAutoencoderKL
from safe_denoiser_tpu.models import clip_text as j_clip
from safe_denoiser_tpu.pipeline import sampler as j_sampler
from safe_denoiser_tpu.repellency import methods as j_methods
from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPMScheduler
from safe_denoiser_tpu.text import CLIPTokenizer as JCLIPTokenizer
from safe_denoiser_tpu_torch.models import clip_text as t_clip
from safe_denoiser_tpu_torch.pipeline import (
    EraseSpec, GuidanceConfig, RepellencyWindow, SafeDiffusionPipeline,
    sample_sd)
from safe_denoiser_tpu_torch.repellency import (
    KernelFastRepellency, RepellencyConfig)
from safe_denoiser_tpu_torch.schedulers import DDPMScheduler
from safe_denoiser_tpu_torch.text import CLIPTokenizer
from tests.test_torch_port_models import (
    jax_unet, jax_vae, load, random_params, torch_unet, torch_vae)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "safe_denoiser_tpu_torch")
PROMPTS = ["a cat on a sofa", "the dog runs"]
STEPS, B = 5, 2


@pytest.fixture
def vocab_dir(tmp_path):
    chip_smoke.write_tiny_vocab(str(tmp_path))
    return str(tmp_path)


def test_tokenizer_matches_jax(vocab_dir):
    mine = CLIPTokenizer.from_pretrained(vocab_dir, max_length=16)
    ref = JCLIPTokenizer.from_pretrained(vocab_dir, max_length=16)
    for text in PROMPTS + ["", "weird   spacing\tand&amp;entities!",
                           "a cat's dog " * 6]:
        assert mine(text) == ref(text)


def test_slice_matches_jax(vocab_dir):
    """Tokenize -> CLIP encode -> 5 DDPM steps with CFG and kernel_fast
    repellency (window by timestep) -> VAE decode, in both packages on the
    same weights and the JAX noise stream, f32. Tolerances: latents as the
    loop parity (f32 sums in another order, amplified over the steps);
    images 1e-2, the latent difference through the decoder."""
    tok = CLIPTokenizer.from_pretrained(vocab_dir, max_length=16)
    ckw = dict(vocab_size=max(tok.vocab.values()) + 1, hidden_size=32,
               num_layers=2, num_heads=2, max_position_embeddings=16,
               intermediate_size=64, eos_token_id=tok.eos_token_id)
    j_text = j_clip.CLIPTextModel(j_clip.CLIPTextConfig(**ckw))
    clip_params = random_params(j_text, 7, jax.random.PRNGKey(0),
                                jnp.zeros((1, 16), jnp.int32))
    j_unet_model, unet_params = jax_unet()
    j_vae_model, vae_params = jax_vae()
    pipe = SafeDiffusionPipeline(
        torch_unet(unet_params), torch_vae(vae_params),
        load(t_clip.CLIPTextModel(t_clip.CLIPTextConfig(**ckw)), clip_params,
             t_clip.CLIPTextConfig(**ckw)),
        tok, DDPMScheduler(), device="cpu")

    rs = np.random.RandomState(8)
    lat0 = rs.randn(B, 8, 8, 4).astype(np.float32)
    refs = rs.randn(6, 4, 8, 8).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    rkw = dict(sigma=30.0, scale=0.4, beta_threshold=1e-12)
    window = dict(t_start=1000.0, t_end=300.0)
    rng = jax.random.PRNGKey(99)

    # JAX package
    jtok = JCLIPTokenizer.from_pretrained(vocab_dir, max_length=16)

    def j_encode(texts):
        ids = jnp.asarray(jtok(texts)["input_ids"])
        return j_text.apply(clip_params, ids)[0]

    uncond = j_encode([""])[0]
    text = jnp.stack([jnp.stack([uncond] * B), j_encode(PROMPTS)])
    want_lat, want_app = j_sampler.sample_sd(
        lambda lat, t, c, fu: j_unet_model.apply(unet_params, lat, t, c),
        JDDPMScheduler(), text, jnp.asarray(lat0), rng, STEPS,
        repellency=j_methods.RepellencyConfig(**rkw),
        refs_nchw=jnp.asarray(refs),
        window=j_sampler.RepellencyWindow(**window))
    want_img = j_vae_model.apply(vae_params, want_lat / 0.18215,
                                 method=JAutoencoderKL.decode)

    # the port, fed the same noise
    def noise(i, salt):
        k = jax.random.fold_in(jax.random.fold_in(rng, i), salt)
        n = jax.random.normal(k, lat0.shape, dtype=jnp.float32)
        return torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())

    with torch.no_grad():
        text_t = torch.cat([pipe.encode_prompt(p) for p in PROMPTS], dim=1)
        np.testing.assert_allclose(text_t.numpy(), np.asarray(text),
                                   atol=1e-5, rtol=1e-5)
        lat, applied = sample_sd(
            pipe.unet, pipe.scheduler, text_t,
            torch.from_numpy(lat0.transpose(0, 3, 1, 2).copy()), noise, STEPS,
            guidance=GuidanceConfig(), repellency=RepellencyConfig(**rkw),
            refs=torch.from_numpy(refs),
            window=RepellencyWindow(**window))
        img = pipe.vae.decode(lat / pipe.vae.config.scaling_factor)
    assert applied.any()
    np.testing.assert_array_equal(applied.numpy(), np.asarray(want_app))
    np.testing.assert_allclose(lat.numpy(),
                               np.asarray(want_lat).transpose(0, 3, 1, 2),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(img.numpy(),
                               np.asarray(want_img).transpose(0, 3, 1, 2),
                               atol=1e-2, rtol=1e-2)


def _write_checkpoint(root, vocab_src):
    """A tiny HF-layout SD checkpoint: sharded safetensors + index for the
    UNet, one safetensors file for the VAE, a torch .bin (with the legacy
    position_ids buffer) for the text encoder."""
    from safetensors.numpy import save_file

    from safe_denoiser_tpu_torch.models import (
        AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNet2DConditionModel,
        UNetConfig, VAEConfig)

    torch.manual_seed(3)
    unet = UNet2DConditionModel(UNetConfig(
        sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
        cross_attention_dim=32, num_attention_heads=2, norm_num_groups=8))
    vae = AutoencoderKL(VAEConfig(block_out_channels=(32, 64),
                                  layers_per_block=1, norm_num_groups=8))
    text = CLIPTextModel(CLIPTextConfig(vocab_size=521, hidden_size=32,
                                        num_layers=2, num_heads=2,
                                        intermediate_size=64))
    for sub in ("unet", "vae", "text_encoder", "tokenizer", "scheduler"):
        os.makedirs(os.path.join(root, sub))

    def dump(sub, name, obj):
        with open(os.path.join(root, sub, name), "w") as f:
            json.dump(obj, f)

    dump("unet", "config.json", dict(
        sample_size=8, block_out_channels=[32, 64], layers_per_block=1,
        cross_attention_dim=32, attention_head_dim=2, norm_num_groups=8))
    sd = {k: v.numpy() for k, v in unet.state_dict().items()}
    keys = sorted(sd)
    shards = {"a.safetensors": keys[::2], "b.safetensors": keys[1::2]}
    for fname, ks in shards.items():
        save_file({k: sd[k] for k in ks}, os.path.join(root, "unet", fname))
    dump("unet", "diffusion_pytorch_model.safetensors.index.json",
         {"weight_map": {k: f for f, ks in shards.items() for k in ks}})
    dump("vae", "config.json", dict(block_out_channels=[32, 64],
                                    layers_per_block=1, norm_num_groups=8))
    save_file({k: v.numpy() for k, v in vae.state_dict().items()},
              os.path.join(root, "vae", "diffusion_pytorch_model.safetensors"))
    dump("text_encoder", "config.json", dict(
        vocab_size=521, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, eos_token_id=520))
    tsd = dict(text.state_dict())
    tsd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save(tsd, os.path.join(root, "text_encoder", "pytorch_model.bin"))
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join(vocab_src, name)) as f, \
                open(os.path.join(root, "tokenizer", name), "w") as g:
            g.write(f.read())
    dump("scheduler", "scheduler_config.json", dict(
        beta_schedule="scaled_linear", clip_sample=False, steps_offset=1))
    return unet, vae, text


def test_from_pretrained_and_generate_batch(tmp_path, vocab_dir):
    root = str(tmp_path / "ckpt")
    unet, vae, text = _write_checkpoint(root, vocab_dir)
    pipe = SafeDiffusionPipeline.from_pretrained(root, device="cpu",
                                                 dtype=torch.float32)
    for mine, ref in ((pipe.unet, unet), (pipe.vae, vae),
                      (pipe.text_encoder, text)):
        for (k, a), (_, b) in zip(mine.state_dict().items(),
                                  ref.state_dict().items()):
            assert torch.equal(a, b), k
    assert pipe.tokenizer.eos_token_id == 520

    bank = torch.randn(5, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    proc = KernelFastRepellency(ref_data=bank, embed_fn=lambda x: x,
                                sigma=30.0, scale=0.3, beta_threshold=1e-12,
                                device="cpu")
    kw = dict(num_inference_steps=STEPS, height=16, width=16,
              repellency_processor=proc,
              erase_spec=EraseSpec(repellency=True,
                                   window=RepellencyWindow(1000.0, 300.0)))
    pending = pipe.dispatch_batch(PROMPTS, [11, 12], [7.5, 5.0], **kw)
    images = pending.fetch()
    assert [im.shape for im in images] == [(16, 16, 3)] * 2
    assert all(im.dtype == np.uint8 for im in images)
    assert set(pending.stage_ms) == {"encode", "loop", "decode"}
    assert pending.applied[:3].all() and not pending.applied[3:].any()
    # a row depends on its own seed and guidance only (f32 round-off)
    alone = pipe.dispatch_batch(PROMPTS[1:], [12], [5.0], **kw)
    np.testing.assert_allclose(alone.latents[0].numpy(),
                               pending.latents[1].numpy(), atol=1e-3,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="text method"):
        pipe.dispatch_batch(PROMPTS, [1, 2], [7.5, 7.5],
                            erase_spec=EraseSpec(text_method="esd"))


def test_entry_points_raise_without_gpu(tmp_path, vocab_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    root = str(tmp_path / "ckpt")
    _write_checkpoint(root, vocab_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SafeDiffusionPipeline.from_pretrained(root)
    p = SafeDiffusionPipeline.from_pretrained(root, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SafeDiffusionPipeline(p.unet, p.vae, p.text_encoder, p.tokenizer,
                              p.scheduler)
    with pytest.raises(RuntimeError):
        SafeDiffusionPipeline(p.unet, p.vae, p.text_encoder, p.tokenizer,
                              p.scheduler, device="cuda")


FORBIDDEN = ("jax", "jaxlib", "flax", "safe_denoiser_tpu", "pandas", "PIL",
             "yaml", "safetensors", "transformers")


def test_port_sources_import_nothing_forbidden():
    """The port, chip_smoke.py and the GPU tests (which run on a machine
    without JAX) import none of the forbidden packages."""
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "test_torch_port_cuda.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN, (path, m)


def test_slice_leaves_no_jax_in_sys_modules():
    """In a fresh interpreter: import every module of the port, run the
    tiny slice on the CPU, then no JAX / JAX-package module is loaded."""
    code = """
import json, pkgutil, sys, tempfile, importlib
import safe_denoiser_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from safe_denoiser_tpu_torch import ops
with tempfile.TemporaryDirectory() as d:
    chip_smoke.write_tiny_vocab(d)
    lat, img, applied = chip_smoke.tiny_slice("cpu", d)
assert bool(applied.any()) and img.shape == (2, 3, 16, 16)
bad = sorted(n for n in sys.modules if n.split(".")[0] in %r)
print(json.dumps({"bad": bad, "launches": ops.launch_counts()}))
""" % (FORBIDDEN + ("triton",),)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert set(res["launches"].values()) == {0}
