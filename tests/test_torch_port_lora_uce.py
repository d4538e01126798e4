"""The port's LoRA adapters, UCE/RECE editor and their CLIs against the JAX
package on the CPU (``training/lora.py``, ``training/uce.py``,
``runners/train_esd.py``, ``runners/edit_concepts.py``, both pipelines'
``load_lora``).

Adapter files interchange: an adapter the JAX package saved (both of its
formats) loads into the port and the reverse, giving the same UNet output.
The UNet is ``tests/test_torch_port_models``' tiny f32 one (24x24
latents), filled from numpy and loaded into the port through the bridge.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.runners import edit_concepts as j_edit
from safe_denoiser_tpu.runners import train_esd as j_train
from safe_denoiser_tpu.training import esd as j_esd
from safe_denoiser_tpu.training import lora as j_lora
from safe_denoiser_tpu.training import uce as j_uce
from safe_denoiser_tpu_torch.models import unet as t_unet
from safe_denoiser_tpu_torch.models.weights import load_safetensors
from safe_denoiser_tpu_torch.models.weights_export import from_jax_params
from safe_denoiser_tpu_torch.pipeline import graph
from safe_denoiser_tpu_torch.runners import edit_concepts as t_edit
from safe_denoiser_tpu_torch.runners import train_esd as t_train
from safe_denoiser_tpu_torch.training import esd as t_esd
from safe_denoiser_tpu_torch.training import lora as t_lora
from safe_denoiser_tpu_torch.training import uce as t_uce
from tests.test_torch_port_models import UNET_KW, jax_unet, torch_unet
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

CFG = t_unet.UNetConfig(**UNET_KW)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _sd(module):
    return {n: p.detach() for n, p in module.named_parameters()}


def _inputs(seed=21):
    rs = np.random.RandomState(seed)
    return (rs.randn(1, 24, 24, 4).astype(np.float32), np.array([500]),
            rs.randn(1, 5, 32).astype(np.float32),
            rs.randn(1, 5, 32).astype(np.float32))


@pytest.fixture(scope="module")
def tiny():
    model, params = jax_unet()
    return model, params, torch_unet(params)


def _jax_adapter(params, seed=3, rank=4, targets="xattn"):
    lora = j_lora.init_lora_params(params, jax.random.PRNGKey(seed), rank,
                                   targets)
    rs = np.random.RandomState(seed)
    return {p: {"a": ab["a"], "b": jnp.asarray(
        rs.randn(*ab["b"].shape).astype(np.float32) * 0.05)}
        for p, ab in lora.items()}


def _to_torch(lora):
    return {p: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()}
            for p, ab in lora.items()}


@pytest.mark.parametrize("targets", ["xattn", "selfattn", "attn", "noxattn",
                                     "full", "ff"])
def test_target_paths_match_jax(tiny, targets):
    _, params, module = tiny
    want = j_lora.lora_target_paths(params, targets)
    assert t_lora.lora_target_paths(_sd(module), targets,
                                    model_cfg=CFG) == want


def test_target_paths_refuse_int8(tiny):
    _, _, module = tiny
    sd = {n: (p.to(torch.int8) if n.endswith("attn2.to_k.weight") else p)
          for n, p in _sd(module).items()}
    with pytest.raises(ValueError, match="integer dtype"):
        t_lora.lora_target_paths(sd, "xattn", model_cfg=CFG)
    with pytest.raises(ValueError, match="matched no 2-D kernel"):
        t_lora.lora_target_paths(_sd(module), "nothing_here", model_cfg=CFG)


def test_zero_b_merge_is_bit_identical(tiny):
    _, _, module = tiny
    sd = _sd(module)
    lora = t_lora.init_lora_params(sd, torch.Generator().manual_seed(0), 4,
                                   "attn", model_cfg=CFG)
    merged = t_lora.apply_lora(sd, lora, 0.7, model_cfg=CFG)
    assert len(lora) == 32     # q, k, v, out of attn1 and attn2 x 4 blocks
    for n, w in sd.items():
        assert torch.equal(merged[n], w), n
    with pytest.raises(ValueError, match="matching no param"):
        t_lora.apply_lora(sd, {"params/nope/kernel": lora[next(iter(lora))]},
                          model_cfg=CFG)


def _run_unet(module, sd, x, t, ctx):
    mod = torch_unet(jax_unet()[1])
    mod.load_state_dict(sd)
    with torch.no_grad():
        return mod(_nchw(x), int(t[0]), torch.from_numpy(ctx)).numpy()


@pytest.mark.parametrize("ext", [".safetensors", ".pt"])
def test_adapter_files_interchange_with_jax(tiny, tmp_path, ext):
    """JAX's save_lora -> the port's load_lora (through merge_lora_into)
    and the port's save_lora -> JAX's load_lora: the merged UNets' outputs
    agree within 1e-5 and the metadata survives."""
    model, params, module = tiny
    x, t, ctx, _ = _inputs()
    lora_j = _jax_adapter(params)
    path_j = str(tmp_path / ("jax" + ext))
    j_lora.save_lora(path_j, lora_j, 4, alpha=8.0, targets="xattn",
                     metadata={"prompt": "nudity"})
    apply = jax.jit(model.apply)
    want = np.asarray(apply(j_lora.apply_lora(params, lora_j, 2.0),
                            jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    merged = t_lora.merge_lora_into(_sd(module), path_j, model_cfg=CFG)
    got = _run_unet(module, merged, x, t, ctx)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5,
                               rtol=1e-5)

    lora_t, meta = t_lora.load_lora(path_j)
    assert meta["rank"] == 4 and meta["alpha"] == 8.0
    assert meta["targets"] == "xattn" and meta["prompt"] == "nudity"
    path_t = str(tmp_path / ("port" + ext))
    t_lora.save_lora(path_t, lora_t, 4, alpha=8.0, targets="xattn",
                     metadata={"prompt": "nudity"})
    back, meta_j = j_lora.load_lora(path_t)
    assert int(meta_j["rank"]) == 4 and float(meta_j["alpha"]) == 8.0
    want_back = np.asarray(apply(
        j_lora.apply_lora(params, back, 2.0), jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx)))
    np.testing.assert_allclose(got, want_back.transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-5)


def test_lora_esd_steps_match_jax(tiny):
    """Two LoRA-ESD steps at lr 1e-3: the first gradient of the adapter,
    each loss, and the factors after two steps (within 2e-2 lr for 95% of
    the entries, within the steps' reach everywhere: AdamW moves an entry
    by about lr whatever its gradient's size)."""
    model, params, module = tiny
    x, t, ctx_c, ctx_u = _inputs(22)
    lora_j = _jax_adapter(params, seed=5)
    lr = 1e-3
    jconf = j_esd.ESDConfig(learning_rate=lr)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx_c),
            jnp.asarray(ctx_u))
    g_j = jax.jit(jax.grad(lambda l: j_esd.esd_loss(
        model.apply, j_lora.apply_lora(params, l, 1.0), params, *args,
        1.0)))(lora_j)
    step_j = j_lora.make_lora_esd_train_step(model.apply, jconf, 1.0,
                                             donate=False)
    opt_j = j_esd.make_optimizer(jconf).init(lora_j)
    l_j = lora_j
    lora = _to_torch(lora_j)
    sd = _sd(module)
    conf = t_esd.ESDConfig(learning_rate=lr)
    opt = t_esd.make_optimizer(conf, lora)
    apply_fn = t_esd.module_apply_fn(module, torch.float32)
    targs = (_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx_c),
             torch.from_numpy(ctx_u))
    loss = t_esd.esd_loss(apply_fn, t_lora.apply_lora(sd, lora, 1.0,
                                                      model_cfg=CFG),
                          sd, *targs)
    loss.backward()
    for p, ab in lora.items():
        for k in "ab":
            w = np.asarray(g_j[p][k])
            assert np.abs(ab[k].grad.numpy() - w).max() <= \
                2e-4 * np.abs(w).max(), (p, k)
    step = t_lora.make_lora_esd_train_step(apply_fn, conf, 1.0,
                                           model_cfg=CFG)
    for _ in range(2):
        l_j, opt_j, loss_j = step_j(l_j, opt_j, params, *args)
        _, _, loss = step(lora, opt, sd, *targs)
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    near = total = 0
    for p, ab in lora.items():
        for k in "ab":
            d = np.abs(ab[k].detach().numpy() - np.asarray(l_j[p][k]))
            assert d.max() <= 2 * 2 * lr
            near += int((d <= 2e-2 * lr).sum())
            total += d.size
    assert near >= 0.95 * total
    for n, w in sd.items():              # the base never moves
        assert torch.equal(w, dict(module.named_parameters())[n].detach())


def _states(seed, n, length=5, d=32):
    rs = np.random.RandomState(seed)
    return [rs.randn(length, d).astype(np.float32) for _ in range(n)]


def _check_edit(edited, want_tree, module, tol=1e-4):
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, want_tree),
                           CFG)
    base = _sd(module)
    kv = set(t_uce.cross_attn_kv_paths(base))
    assert len(kv) == 8        # to_k, to_v of attn2 x 4 blocks
    for n, w in edited.items():
        if n in kv:
            d = np.abs(w.numpy() - want[n]).max()
            assert d <= tol * np.abs(want[n]).max(), n
            assert not torch.equal(w, base[n])
        else:
            assert torch.equal(w, base[n]), n


def test_uce_and_rece_match_jax(tiny):
    """UCE and RECE on random token states: two concepts, their targets,
    one preserved prompt; the edited K/V weights within 1e-4 (relative to
    each weight's largest entry) of JAX's, every other weight untouched.

    RECE's adversarial embedding solves with sum W' W'^T, which UCE leaves
    nearly singular on these random weights (condition number ~9e4 against
    3 before the edit), so f32 round-off in either package's solve grows by
    that factor: a round at the default shrinkage (0.1) parts the two by
    ~8e-3, and a second round by O(1). RECE is held at 1e-4 where the
    shrinkage toward the targets keeps the round well posed (0.9), and at
    2e-2 for one round at the default."""
    _, params, module = tiny
    ec, et, pc = _states(30, 2), _states(31, 2), _states(32, 1)
    jargs = ([jnp.asarray(a) for a in ec], [jnp.asarray(a) for a in et],
             [jnp.asarray(a) for a in pc])
    targs = ([torch.from_numpy(a) for a in ec],
             [torch.from_numpy(a) for a in et],
             [torch.from_numpy(a) for a in pc])
    with torch.no_grad():
        _check_edit(t_uce.uce_edit(_sd(module), *targs, lamb=0.3),
                    j_uce.uce_edit(params, *jargs, lamb=0.3), module)
        _check_edit(t_uce.rece_edit(_sd(module), *targs, iterations=1,
                                    regularize=0.9),
                    j_uce.rece_edit(params, *jargs, iterations=1,
                                    regularize=0.9), module)
        table = {"nudity": ec[0], "": et[0], "a person": pc[0]}
        for method, tol in (("uce", 1e-4), ("rece", 2e-2)):
            got = t_uce.edit_unet_concepts(
                _sd(module), lambda s: torch.from_numpy(table[s]),
                ["nudity"], preserve=["a person"], method=method,
                rece_iterations=1)
            want = j_uce.edit_unet_concepts(
                params, lambda s: jnp.asarray(table[s]), ["nudity"],
                preserve=["a person"], method=method, rece_iterations=1)
            _check_edit(got, want, module, tol)


# -------------------------------------------------------------- the CLIs
def _dests(parser_fn, argv=()):
    return vars(parser_fn(list(argv)))


@pytest.mark.parametrize("port,jax_", [(t_train, j_train),
                                       (t_edit, j_edit)])
def test_cli_flags_match_jax(port, jax_):
    """The same destinations and defaults, apart from --device."""
    got = _dests(port.parse_args)
    assert got.pop("device") == "cuda"
    assert got == _dests(jax_.parse_args)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import chip_smoke
    from tests.test_torch_port_pipeline import _write_checkpoint
    root = tmp_path_factory.mktemp("train_ckpt")
    vocab = root / "vocab"
    vocab.mkdir()
    chip_smoke.write_tiny_vocab(str(vocab))
    _write_checkpoint(str(root / "ckpt"), str(vocab))
    return str(root / "ckpt")


def _jax_layout(ckpt_dir):
    """Keys and shapes of JAX's ``invert_unet`` export of the checkpoint."""
    from safe_denoiser_tpu.models.weights import (convert_unet,
                                                  load_component_config,
                                                  load_sharded_state_dict)
    from safe_denoiser_tpu.models.weights_export import invert_unet
    unet_dir = os.path.join(ckpt_dir, "unet")
    cfg = load_component_config(unet_dir, "unet")
    tree = convert_unet(load_sharded_state_dict(unet_dir), cfg)
    return {k: tuple(np.shape(v))
            for k, v in invert_unet(tree["params"], cfg).items()}


def _base(ckpt_dir, *extra):
    return ["--model_dir", ckpt_dir, "--iterations", "2",
            "--image_length", "64", "--denoise_steps", "2", "--device",
            "cpu", "--log_every", "1", *extra]


def test_train_esd_cli_full_and_lora(ckpt, tmp_path):
    """noxattn: the export's keys and shapes are JAX's invert_unet's, f32,
    and it loads through load_unet_state_dict. LoRA (xattn): only attn2
    weights differ from the checkpoint, and the saved adapter loaded
    through the pipeline's load_lora equals the exported merge bit for
    bit; JAX's load_lora reads the adapter."""
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    full = str(tmp_path / "full.safetensors")
    t_train.main(_base(ckpt, "--save_path", full))
    got = load_safetensors(full)
    assert {k: tuple(v.shape) for k, v in got.items()} == _jax_layout(ckpt)
    assert all(v.dtype == torch.float32 for v in got.values())
    pipe = SafeDiffusionPipeline.from_pretrained(ckpt, device="cpu",
                                                 dtype=torch.float32)
    orig = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    pipe.load_unet_state_dict(full)
    for k, v in pipe.unet.state_dict().items():
        assert torch.equal(v, got[k])
    assert not torch.equal(got["conv_in.weight"], orig["conv_in.weight"])
    assert torch.equal(got["conv_out.weight"], orig["conv_out.weight"])

    merged = str(tmp_path / "lora_merged.pt")
    adapter = str(tmp_path / "adapter.safetensors")
    t_train.main(_base(ckpt, "--save_path", merged, "--lora_rank", "2",
                       "--train_method", "xattn", "--lr", "1e-2",
                       "--save_lora_path", adapter))
    want = torch.load(merged, weights_only=True)
    changed = [k for k in want if not torch.equal(want[k], orig[k])]
    assert changed and all("attn2" in k for k in changed)
    pipe = SafeDiffusionPipeline.from_pretrained(ckpt, device="cpu",
                                                 dtype=torch.float32)
    before = graph.weights_version(pipe.unet, pipe.vae)
    pipe.load_lora(adapter)
    assert graph.weights_version(pipe.unet, pipe.vae) > before
    for k, v in pipe.unet.state_dict().items():
        assert torch.equal(v, want[k]), k
    lora_j, meta_j = j_lora.load_lora(adapter)
    assert int(meta_j["rank"]) == 2 and meta_j["targets"] == "xattn"
    assert set(lora_j) == set(t_lora.load_lora(adapter)[0])


def test_train_esd_resume_with_a_changed_rank_raises(ckpt, tmp_path):
    save = str(tmp_path / "l.safetensors")
    t_train.main(_base(ckpt, "--save_path", save, "--lora_rank", "2",
                       "--save_every", "1", "--iterations", "1"))
    assert os.path.exists(save + ".train_state")
    with pytest.raises(ValueError, match="different hyperparameters"):
        t_train.main(_base(ckpt, "--save_path", save, "--lora_rank", "3",
                           "--resume"))


def test_edit_concepts_cli(ckpt, tmp_path):
    """RECE through the CLI: the export has JAX's layout and only the
    cross-attention K/V weights differ from the checkpoint."""
    from safe_denoiser_tpu_torch.models.weights import \
        load_sharded_state_dict
    out = str(tmp_path / "rece.safetensors")
    t_edit.main(["--model_dir", ckpt, "--method", "rece", "--erase",
                 "nudity", "--preserve", "a person", "--rece_iterations",
                 "1", "--save_path", out, "--device", "cpu"])
    got = load_safetensors(out)
    assert {k: tuple(v.shape) for k, v in got.items()} == _jax_layout(ckpt)
    orig = load_sharded_state_dict(os.path.join(ckpt, "unet"))
    changed = {k for k in got if not torch.equal(got[k], orig[k].float())}
    assert changed == set(t_uce.cross_attn_kv_paths(got))
    assert "edit_logs.txt" in os.listdir(tmp_path)


def test_load_lora_refuses_int8_and_runs_on_sd3(ckpt, tmp_path):
    """The SD-v1 pipeline refuses an adapter after enable_int8; the SD3
    pipeline's load_lora merges an MMDiT adapter into its weights."""
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    from tests.test_torch_port_sd3 import write_tiny_sd3_checkpoint
    pipe = SafeDiffusionPipeline.from_pretrained(ckpt, device="cpu",
                                                 dtype=torch.float32)
    sd = _sd(pipe.unet)
    lora = t_lora.init_lora_params(sd, torch.Generator().manual_seed(1), 2,
                                   "xattn", model_cfg=pipe.unet.config)
    path = str(tmp_path / "a.safetensors")
    t_lora.save_lora(path, lora, 2)
    pipe.enable_int8(min_dim=32)
    with pytest.raises(ValueError, match="load_lora after enable_int8"):
        pipe.load_lora(path)

    vocab = tmp_path / "vocab"
    vocab.mkdir()
    import chip_smoke
    chip_smoke.write_tiny_vocab(str(vocab))
    pipe3 = write_tiny_sd3_checkpoint(str(tmp_path / "sd3"), str(vocab))
    tf = pipe3.transformer
    sd3 = _sd(tf)
    lora3 = t_lora.init_lora_params(sd3, torch.Generator().manual_seed(2),
                                    2, "attn_", model_cfg=tf.config)
    for ab in lora3.values():
        ab["b"].normal_(0, 0.1)
    want = t_lora.apply_lora(sd3, lora3, 1.0, model_cfg=tf.config)
    path3 = str(tmp_path / "sd3.pt")
    t_lora.save_lora(path3, lora3, 2, targets="attn_")
    pipe3.load_lora(path3)
    got = _sd(pipe3.transformer)
    assert any("attn.to_q" in n for n in want)
    for n, w in want.items():
        assert torch.equal(got[n], w), n
