"""The port's CLIP vision tower, Q16 gate and CLIP evaluators against the
JAX package (and both CLIP towers against HF transformers) on the CPU,
f32, on tiny towers made from seeds.

Weights: a tiny JAX tower's parameters go through ``from_jax_params``; an
HF tower's state dict goes into the port by its own names
(``clip_vision_state_dict``) and into JAX through ``convert_clip_vision``.
"""

import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# transformers would import TensorFlow (installed here) for classes no
# test uses: ~8 s of a worker's time
os.environ.setdefault("USE_TF", "0")
import transformers  # noqa: E402
from safetensors.numpy import save_file  # noqa: E402

from safe_denoiser_tpu.evals import clip_metrics as j_metrics
from safe_denoiser_tpu.evals import q16 as j_q16
from safe_denoiser_tpu.models import CLIPTextConfig as JTextConfig
from safe_denoiser_tpu.models import CLIPTextModel as JTextModel
from safe_denoiser_tpu.models import clip_vision as j_cv
from safe_denoiser_tpu.models.weights import convert_clip_text
from safe_denoiser_tpu_torch.evals import clip_metrics as t_metrics
from safe_denoiser_tpu_torch.evals import q16 as t_q16
from safe_denoiser_tpu_torch.models import CLIPTextConfig, CLIPTextModel
from safe_denoiser_tpu_torch.models import clip_vision as t_cv
from safe_denoiser_tpu_torch.models.weights import clip_vision_state_dict
from safe_denoiser_tpu_torch.models.weights_export import from_jax_params
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

# f32 towers of two layers: sums in another order agree to this
ATOL = 2e-5
TINY = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, projection_dim=24)


def _images(n, side, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (side, side, 3), dtype=np.uint8)
            for _ in range(n)]


def _hf_vision(seed=0, **over):
    kw = dict(image_size=32, patch_size=8, hidden_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, hidden_act="quick_gelu",
              projection_dim=24)
    kw.update(over)
    torch.manual_seed(seed)
    return transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(**kw)).eval()


def test_vision_tower_matches_jax():
    """from_jax_params of a tiny JAX tower (2 layers, width 64): the
    last hidden state, the pooled CLS and the projection."""
    jm = j_cv.CLIPVisionModel(j_cv.CLIPVisionConfig(**TINY))
    tcfg = t_cv.CLIPVisionConfig(**TINY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 32, 32, 3)))
    tm = t_cv.CLIPVisionModel(tcfg)
    tm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in
                        from_jax_params(params, tcfg).items()}, strict=True)
    x = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("side,dtype", [(512, "uint8"), (64, "uint8"),
                                        (224, "uint8"), (100, "float01")])
def test_preprocess_matches_jax(side, dtype):
    """Bicubic with antialiasing when shrinking (512 -> 224), plain bicubic
    when growing, none at 224; [0, 255] or [0, 1] by the batch's max."""
    imgs = np.stack(_images(2, side, side))
    if dtype == "float01":
        imgs = imgs.astype(np.float32) / 255.0
    want = np.asarray(j_cv.preprocess_clip(jnp.asarray(imgs)))
    got = t_cv.preprocess_clip(torch.from_numpy(imgs)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_vision_tower_matches_hf_transformers():
    """The port's tower on an HF CLIPVisionModelWithProjection state dict,
    taken by its own names: outputs equal HF's."""
    hf = _hf_vision()
    tm = t_cv.CLIPVisionModel(t_cv.CLIPVisionConfig(**TINY))
    tm.load_state_dict(clip_vision_state_dict(hf.state_dict(), 24),
                       strict=True)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        out = hf(x, output_hidden_states=True)
        want_pooled = hf.vision_model(x).pooler_output
        last, pooled, proj = tm(x)
    np.testing.assert_allclose(last.numpy(), out.last_hidden_state.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), want_pooled.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(proj.numpy(), out.image_embeds.numpy(),
                               atol=ATOL)


def test_vision_state_dict_spellings():
    """An unprefixed state dict with ``pre_layernorm`` and no projection
    head (the other spellings JAX's converter takes) loads, with an
    identity projection."""
    hf = _hf_vision()
    sd = {k[len("vision_model."):]: v for k, v in hf.state_dict().items()
          if k.startswith("vision_model.")}
    sd = {k.replace("pre_layrnorm", "pre_layernorm"): v
          for k, v in sd.items()}
    cfg = t_cv.CLIPVisionConfig(**{**TINY, "projection_dim": 64})
    tm = t_cv.CLIPVisionModel(cfg)
    tm.load_state_dict(clip_vision_state_dict(sd, 64), strict=True)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, pooled, proj = tm(x)
        want = hf.vision_model(x).pooler_output
    np.testing.assert_array_equal(proj.numpy(), pooled.numpy())
    np.testing.assert_allclose(pooled.numpy(), want.numpy(), atol=ATOL)


def test_text_tower_matches_hf_transformers():
    """The port's CLIPTextModel on an HF CLIPTextModelWithProjection state
    dict (eos 119: HF's first-EOS pooling): last and penultimate hidden
    states, the projection."""
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=120, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16, hidden_act="quick_gelu",
        projection_dim=24, eos_token_id=119, bos_token_id=0, pad_token_id=1)
    torch.manual_seed(0)
    hf = transformers.CLIPTextModelWithProjection(hf_cfg).eval()
    cfg = CLIPTextConfig(vocab_size=120, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64,
                         max_position_embeddings=16, hidden_act="quick_gelu",
                         projection_dim=24, eos_token_id=119)
    tm = CLIPTextModel(cfg, with_projection=True)
    sd = dict(hf.state_dict())
    sd.pop("text_model.embeddings.position_ids", None)
    tm.load_state_dict(sd, strict=True)
    ids = torch.tensor([[0, 5, 9, 119, 1, 1, 1, 1], [0, 7, 119, 1, 1, 1, 1,
                                                     1]])
    with torch.no_grad():
        out = hf(ids, output_hidden_states=True)
        last, penult, _, proj = tm(ids)
    np.testing.assert_allclose(last.numpy(), out.last_hidden_state.numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(penult.numpy(), out.hidden_states[-2].numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(proj.numpy(), out.text_embeds.numpy(),
                               atol=ATOL)
    # the JAX package's text tower on the same weights
    jcfg = JTextConfig(vocab_size=120, hidden_size=32, num_layers=2,
                       num_heads=4, intermediate_size=64,
                       max_position_embeddings=16, hidden_act="quick_gelu",
                       projection_dim=24, eos_token_id=119)
    jp = convert_clip_text({k: v.numpy() for k, v in sd.items()}, jcfg)
    jlast = JTextModel(jcfg).apply(jp, jnp.asarray(ids.numpy()))[0]
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)


# ------------------------------------------------------------------- Q16
@pytest.fixture
def q16_assets(tmp_path, monkeypatch):
    """A tiny HF tower as a safetensors file and a [2, 24] prompt pair as a
    pickle and a torch .pt; the width-64 tower's head count (4) entered in
    both packages' table of known towers."""
    monkeypatch.setitem(j_q16._KNOWN_VISION_HEADS, 64, 4)
    monkeypatch.setitem(t_q16._KNOWN_VISION_HEADS, 64, 4)
    sd = {k: v.numpy() for k, v in _hf_vision(seed=3).state_dict().items()}
    w = tmp_path / "vision.safetensors"
    save_file(sd, str(w))
    prompts = np.random.RandomState(5).randn(2, 24).astype(np.float32)
    pk = tmp_path / "q16.p"
    pk.write_bytes(pickle.dumps(prompts))
    pt = tmp_path / "q16.pt"
    torch.save(torch.from_numpy(prompts).half(), pt)
    return sd, str(w), str(pk), str(pt)


def test_infer_config_matches_jax(q16_assets):
    sd = q16_assets[0]
    want = j_q16.infer_clip_vision_config(sd)
    got = t_q16.infer_clip_vision_config(sd)
    assert got == t_cv.CLIPVisionConfig(**vars(want))
    assert got == t_cv.CLIPVisionConfig(**TINY)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        odd = {k: (v if "patch_embedding" not in k
                   else np.zeros((96, 3, 8, 8), np.float32))
               for k, v in sd.items()}
        assert t_q16.infer_clip_vision_config(odd).num_heads == \
            j_q16.infer_clip_vision_config(odd).num_heads == 1
    assert any("unknown CLIP vision hidden size" in str(w.message)
               for w in caught)


def test_q16_eval_matches_jax(q16_assets):
    """Q16Eval from the weights file: embeddings within ATOL of JAX's on
    512^2 images, and the same decisions and similarities (within 1e-3)
    from ``__call__`` and ``eval_many``, groups of one and more images."""
    _, w, pk, pt = q16_assets
    jev = j_q16.Q16Eval(pk, clip_weights_path=w)
    tev = t_q16.Q16Eval(pk, clip_weights_path=w, device="cpu")
    imgs = _images(6, 512, 11)
    np.testing.assert_allclose(tev.compute_embeddings(imgs).numpy(),
                               np.asarray(jev.compute_embeddings(imgs)),
                               atol=ATOL)
    for g in ([imgs[0]], imgs[1:3]):
        (tu, tp), (ju, jp) = tev(g), jev(g)
        assert tu == ju
        np.testing.assert_allclose(tp, jp, atol=1e-3)
    groups = [[imgs[0]], imgs[1:4], [], [imgs[4]], [imgs[5]]]
    for (tu, tp), (ju, jp) in zip(tev.eval_many(groups),
                                  jev.eval_many(groups)):
        assert tu == ju
        np.testing.assert_allclose(tp, jp, atol=1e-3)
    assert {u for u, _ in tev.eval_many(groups)} == {True, False}, \
        "the seeded images should split between the two labels"
    # the .pt prompt file (f16, as the reference ships it)
    tpt = t_q16.Q16Eval(pt, clip_weights_path=w, device="cpu")
    assert [u for u, _ in tpt.eval_many(groups)] == \
        [u for u, _ in tev.eval_many(groups)]


def test_q16_eval_needs_weights(q16_assets):
    with pytest.raises(ValueError, match="vision weights"):
        t_q16.Q16Eval(q16_assets[2], device="cpu")


def test_clip_metrics_match_jax():
    rs = np.random.RandomState(8)
    a, b = rs.randn(5, 16).astype(np.float32), rs.randn(5, 16).astype(
        np.float32)
    np.testing.assert_allclose(
        t_metrics.clip_score(torch.from_numpy(a), torch.from_numpy(b)),
        np.asarray(j_metrics.clip_score(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-4)
    prompts = rs.randn(2, 16).astype(np.float32)
    tu, tp = t_metrics.Q16Classifier(prompts)(torch.from_numpy(a))
    ju, jp = j_metrics.Q16Classifier(prompts)(jnp.asarray(a))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    with pytest.raises(ValueError, match="two prompt"):
        t_metrics.Q16Classifier(prompts[:1])
    # AES: a torch Sequential state dict under the reference's names
    mlp = t_metrics.AestheticMLP(16)
    sd = {k: v.numpy() for k, v in mlp.state_dict().items()}
    want = j_metrics.aes_score(j_metrics.convert_aes_mlp(sd), jnp.asarray(a))
    got = t_metrics.aes_score(t_metrics.convert_aes_mlp(sd),
                              torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
