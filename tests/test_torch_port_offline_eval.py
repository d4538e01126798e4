"""The port's offline evaluators against the JAX package on the CPU, f32:
the FID/KID/IS math, the FID InceptionV3, image loading, PIL's BICUBIC,
the OpenCLIP converters and factory, and every ``evaluate_*`` (through the
``runners.evaluate`` CLIs where the root scripts call them) on a small
temp tree.

Weights come from seeds and go into both packages: the port's tower's
state dict is written to a file that each package loads by its own
converter. The CLIP towers are tiny: the functions that fix a tower
(CLIP ViT-B/32, ViT-L/14, ViT-H/14) get a tiny config through the same
module constants in both packages.
"""

import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from safetensors.numpy import save_file

import evaluate_coco30k_fid_clip as j_cli_fid
import evaluate_copro_aes_clip as j_cli_aes
import safe_denoiser_tpu.models as j_models
from safe_denoiser_tpu.evals import metrics as j_metrics
from safe_denoiser_tpu.evals import offline as j_offline
from safe_denoiser_tpu.evals.inception import InceptionV3 as JInception
from safe_denoiser_tpu.evals.inception import convert_inception
from safe_denoiser_tpu.models import openclip_factory as j_ocf
from safe_denoiser_tpu_torch.data import images as t_images
from safe_denoiser_tpu_torch.evals import inception as t_inception
from safe_denoiser_tpu_torch.evals import metrics as t_metrics
from safe_denoiser_tpu_torch.evals import offline as t_offline
from safe_denoiser_tpu_torch.models import (CLIPTextConfig, CLIPTextModel,
                                            CLIPVisionConfig,
                                            CLIPVisionModel)
from safe_denoiser_tpu_torch.models import openclip_factory as t_ocf
from safe_denoiser_tpu_torch.models import weights as t_weights
from safe_denoiser_tpu_torch.models.weights_export import from_jax_params
from safe_denoiser_tpu_torch.runners import coco30k as t_coco
from safe_denoiser_tpu_torch.runners import evaluate as t_evaluate
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# two-layer f32 towers and the 94-conv Inception: sums in another order
# agree to this, relative to the output's largest magnitude
RTOL = 1e-4
# 224^2 input as the JAX package's evaluators preprocess to it, 16 patches
TINY_VISION = dict(image_size=224, patch_size=56, hidden_size=32,
                   num_layers=2, num_heads=2, intermediate_size=64,
                   projection_dim=16)
TINY_TEXT = dict(vocab_size=521, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, projection_dim=16, eos_token_id=520)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= rtol * scale, \
        (float(np.abs(a - b).max()), scale)


# ------------------------------------------------------------- metrics
def test_fid_kid_is_equal_the_jax_package():
    """The copied numpy/scipy math, bit for bit on the same float64
    features: FID (with its sqrtm), KID over 100 subsets of <= 50 rows
    from RandomState(seed), IS over 10 splits."""
    rs = np.random.RandomState(0)
    a, b = rs.randn(60, 16), rs.randn(70, 16) * 1.3 + 0.2
    sa, sb = t_metrics.stats_from_features(a), j_metrics.stats_from_features(a)
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))
    s2 = t_metrics.stats_from_features(b)
    assert t_metrics.frechet_distance(*sa, *s2) == \
        j_metrics.frechet_distance(*sa, *s2)
    for seed in (0, 3):
        assert t_metrics.kid_from_features(a, b, seed=seed) == \
            j_metrics.kid_from_features(a, b, seed=seed)
    logits = rs.randn(37, 1008) * 3
    assert t_metrics.inception_score_from_logits(logits) == \
        j_metrics.inception_score_from_logits(logits)


# ----------------------------------------------------------- Inception
@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """The port's InceptionV3 with seeded weights (BatchNorm statistics
    away from identity) and its state dict as a safetensors file."""
    model = t_inception.init_random_(t_inception.InceptionV3(),
                                     torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.tensor(rs.uniform(0.5, 1.5, n)))
                m.bias.copy_(torch.tensor(rs.randn(n) * 0.1))
                m.running_mean.copy_(torch.tensor(rs.randn(n) * 0.1))
                m.running_var.copy_(torch.tensor(rs.uniform(0.5, 2.0, n)))
    path = tmp_path_factory.mktemp("inception") / "pt_inception.safetensors"
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    save_file(sd, str(path))
    return model.eval(), sd, str(path)


def test_inception_matches_jax_on_the_same_weights(inception):
    """pool3 [2, 2048] and logits [2, 1008] against the JAX InceptionV3
    on convert_inception of the same state dict, within 1e-4 of the
    largest magnitude; ``from_jax_params`` inverts ``convert_inception``
    exactly and its dict loads strictly."""
    import jax
    model, sd, _ = inception
    params = convert_inception(sd)
    back = from_jax_params(params, t_inception.FID_INCEPTION)
    assert set(back) == {k for k in sd if "num_batches_tracked" not in k}
    assert all(np.array_equal(back[k], sd[k]) for k in back)
    t_inception.InceptionV3().load_state_dict(
        t_weights.as_tensors(back))
    x = np.random.RandomState(2).rand(2, 299, 299, 3).astype(np.float32)
    with torch.no_grad():
        pool3, logits = model(torch.as_tensor(x))
    j_pool3, j_logits = jax.jit(lambda p, v: JInception().apply(p, v))(
        params, x)
    assert pool3.shape == (2, 2048) and logits.shape == (2, 1008)
    _close(pool3.numpy(), j_pool3)
    _close(logits.numpy(), j_logits)


def test_inception_state_dict_drops_the_aux_classifier(inception):
    """A torchvision inception_v3 file carries AuxLogits.* (and
    num_batches_tracked): the port loads it strictly without them."""
    _, sd, _ = inception
    extra = dict(sd, **{"AuxLogits.fc.weight": np.zeros((1008, 768),
                                                         np.float32)})
    m = t_inception.InceptionV3()
    m.load_state_dict(t_inception.inception_state_dict(extra))
    assert torch.equal(m.fc.weight, torch.as_tensor(sd["fc.weight"]))


def test_inception_features_need_weights_or_the_random_flag():
    with pytest.raises(ValueError, match="pt_inception-2015-12-05"):
        t_offline.InceptionFeatures(device="cpu")
    a = t_offline.InceptionFeatures(allow_random_init=True, device="cpu")
    b = t_offline.InceptionFeatures(allow_random_init=True, device="cpu")
    for (k, v), w in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(v, w), k


# --------------------------------------------------- images and resizing
@pytest.mark.parametrize("hw,size", [((512, 512), (224, 224)),
                                     ((200, 300), (224, 149)),
                                     ((300, 200), (149, 224)),
                                     ((40, 24), (64, 52))],
                         ids=["512-224", "300x200-224x149",
                              "200x300-149x224", "up"])
def test_bicubic_resize_matches_pil(hw, size):
    img = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3),
                                               dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))
    assert np.array_equal(t_images.resize_bicubic(img, size), want)


def _write_pngs(d, names, side, seed):
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for name in names:
        Image.fromarray(rs.randint(0, 256, (side, side, 3), dtype=np.uint8)
                        ).save(d / name)


def test_load_image_and_listing_match_jax(tmp_path):
    """PNG decode, the 299^2 BILINEAR resize and the sorted png/jpg/jpeg
    listing equal JAX's (PIL-read) bit for bit; a JPEG goes through PIL."""
    _write_pngs(tmp_path, ["b.png", "a_1.png"], 40, 0)
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(tmp_path / "c.jpg")
    (tmp_path / "d.txt").write_text("x")
    paths = t_offline.list_images(str(tmp_path))
    assert paths == j_offline.list_images(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["a_1.png", "b.png",
                                                    "c.jpg"]
    for p in paths:
        for size in (None, 299):
            got = t_offline.load_image(p, size)
            assert got.dtype == np.float32
            assert np.array_equal(got, j_offline.load_image(p, size))


# ------------------------------------------------------------ CLIP towers
def _tiny_configs(act="quick_gelu"):
    j_v = j_models.CLIPVisionConfig(hidden_act=act, **TINY_VISION)
    j_t = j_models.CLIPTextConfig(hidden_act=act, **TINY_TEXT)
    return (j_v, j_t, CLIPVisionConfig(hidden_act=act, **TINY_VISION),
            CLIPTextConfig(hidden_act=act, **TINY_TEXT))


@pytest.fixture
def tiny_towers(monkeypatch):
    """Tiny configs in place of CLIP ViT-B/32, ViT-L/14 and ViT-H/14 in
    both packages' evaluators (the JAX package builds ViT-B/32's text
    config inline in InLoopClipScore, so its CLIPTextConfig is replaced by
    the tiny one). Returns the port's (vision, text) configs."""
    j_v, j_t, t_v, t_t = _tiny_configs()
    for name in ("CLIP_VISION_VIT_B_32", "CLIP_VISION_VIT_L_14",
                 "CLIP_VISION_VIT_H_14"):
        monkeypatch.setattr(j_models, name, j_v)
        monkeypatch.setattr(t_offline, name, t_v)
    monkeypatch.setattr(j_models, "CLIPTextConfig", lambda **_: j_t)
    monkeypatch.setattr(t_coco, "CLIP_VISION_VIT_B_32", t_v)
    monkeypatch.setattr(t_coco, "CLIP_TEXT_VIT_B_32", t_t)
    return t_v, t_t


def tiny_clip_dir(root, seed=0):
    """An HF CLIPModel-like directory: both tiny towers' state dicts
    (made to score image-text pairs between 0 and 100, not at the clamp)
    (``text_model.*``, ``text_projection``, ``vision_model.*``,
    ``visual_projection``) in one safetensors file and the tiny BPE vocab
    as ``tokenizer/``; returns (dir, vision sd, text sd)."""
    import chip_smoke
    _, _, t_v, t_t = _tiny_configs()
    torch.manual_seed(seed)
    vision = CLIPVisionModel(t_v)
    text = CLIPTextModel(t_t, with_projection=True)
    with torch.no_grad():
        vision.vision_model.embeddings.class_embedding.normal_()
        # one shared direction after the final LayerNorms and one shared
        # projection: image and text embeddings meet at cosines well
        # above 0, so CLIPScore (100 max(cos, 0)) moves with the inputs
        shared = torch.randn(t_v.hidden_size)
        for ln in (vision.vision_model.post_layernorm,
                   text.text_model.final_layer_norm):
            ln.weight.fill_(0.5)
            ln.bias.copy_(shared)
        text.text_projection.weight.copy_(vision.visual_projection.weight)
    vsd = {k: v.numpy() for k, v in vision.state_dict().items()}
    tsd = {k: v.numpy() for k, v in text.state_dict().items()}
    root.mkdir(parents=True, exist_ok=True)
    save_file({**vsd, **tsd}, str(root / "model.safetensors"))
    (root / "tokenizer").mkdir()
    chip_smoke.write_tiny_vocab(str(root / "tokenizer"))
    return str(root), vsd, tsd


def to_open_clip(vsd, tsd=None):
    """HF-named tower state dicts (numpy) in OpenCLIP's layout (packed
    in_proj, right-multiplied projections), by the smoke's writer."""
    import chip_smoke

    def tensors(sd):
        return None if sd is None else {k: torch.as_tensor(v)
                                        for k, v in sd.items()}
    return {k: v.numpy() for k, v in chip_smoke.open_clip_state_dict(
        tensors(vsd), tensors(tsd)).items()}


def test_open_clip_converters_and_model_match_jax(tmp_path, monkeypatch):
    """An OpenCLIP-layout file of both tiny towers: the port's converters
    give back the HF-named state dicts exactly, and
    create_model_and_transforms' encode_image (NCHW and NHWC) and
    encode_text agree with the JAX package's on the same file (the tiny
    configs under "ViT-B-32" in both MODEL_CONFIGS); the preprocess
    equals JAX's (PIL BICUBIC) bit for bit."""
    _, vsd, tsd = tiny_clip_dir(tmp_path / "hf")
    path = tmp_path / "open_clip.safetensors"
    save_file(to_open_clip(vsd, tsd), str(path))
    j_v, j_t, t_v, t_t = _tiny_configs("gelu")
    monkeypatch.setitem(j_ocf.MODEL_CONFIGS, "ViT-B-32", (j_v, j_t))
    monkeypatch.setitem(t_ocf.MODEL_CONFIGS, "ViT-B-32", (t_v, t_t))
    sd = t_weights.load_state_dict(str(path))
    for got, want in ((t_weights.open_clip_vision_state_dict(sd, t_v), vsd),
                      (t_weights.open_clip_text_state_dict(sd, t_t), tsd)):
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), k

    model, _, pre = t_ocf.create_model_and_transforms(
        "ViT-B-32", pretrained=str(path), device="cpu")
    j_model, _, j_pre = j_ocf.create_model_and_transforms(
        "ViT-B-32", pretrained=str(path))
    rs = np.random.RandomState(3)
    imgs = [rs.randint(0, 256, (hw[0], hw[1], 3), dtype=np.uint8)
            for hw in ((45, 30), (32, 32), (20, 50))]
    px = np.stack([pre(i) for i in imgs])
    assert px.shape == (3, 3, 224, 224) and px.dtype == np.float32
    assert np.array_equal(px, np.stack([j_pre(i) for i in imgs]))
    assert np.array_equal(pre(Image.fromarray(imgs[0])), px[0])
    want = j_model.encode_image(px)
    _close(model.encode_image(px).numpy(), want)
    _close(model.encode_image(px.transpose(0, 2, 3, 1)).numpy(), want)
    ids = np.array([[519, 100, 7, 520] + [520] * 73,
                    [519, 65, 520] + [520] * 74])
    _close(model.encode_text(ids).numpy(), j_model.encode_text(ids))


def test_open_clip_factory_refuses_what_it_cannot_run():
    """No download for a bare tag, no unknown model name, no encoder for
    a tower the file lacks; the tower pairs are JAX's."""
    with pytest.raises(FileNotFoundError, match="not a local file"):
        t_ocf.create_model_and_transforms(
            "ViT-H-14", pretrained="laion2b_s32b_b79k", device="cpu")
    with pytest.raises(KeyError, match="unknown OpenCLIP model"):
        t_ocf.create_model_and_transforms("RN50", device="cpu")
    model, _, _ = t_ocf.create_model_and_transforms("ViT-B-32",
                                                    device="cpu")
    with pytest.raises(ValueError, match="no vision weights"):
        model.encode_image(np.zeros((1, 3, 224, 224), np.float32))
    with pytest.raises(ValueError, match="no text tower"):
        model.encode_text(np.zeros((1, 77), np.int64))
    for name, (j_v, j_t) in j_ocf.MODEL_CONFIGS.items():
        t_v, t_t = t_ocf.MODEL_CONFIGS[name]
        assert vars(t_v) == vars(j_v) and vars(t_t) == vars(j_t), name


# -------------------------------------------------- the offline evaluators
@pytest.fixture
def tree(tmp_path):
    """run/all with 3 samples (one named <id>_<tag>.png), 3 references
    sharing their ids plus one unmatched, and a COCO-style CSV."""
    run = tmp_path / "run" / "all"
    _write_pngs(run, ["11.png", "12_x.png", "13.png"], 48, 0)
    refs = tmp_path / "refs"
    _write_pngs(refs, ["11.png", "12.png", "13.png", "99.png"], 40, 1)
    csv = tmp_path / "coco.csv"
    csv.write_text("coco_id,prompt\n11,a cat\n12,a dog on a sofa\n"
                   "13,two birds\n")
    return run, refs, csv


def _yaml(path):
    with open(path) as f:
        text = f.read()
    return text, yaml.safe_load(text)


def _check_yaml_pair(run, name, want, rtol=RTOL):
    """The port's file: PyYAML's bytes for its own numbers, and the JAX
    package's keys, counts and numbers within ``rtol``."""
    text, got = _yaml(run.parent / name)
    assert text == yaml.dump(got)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= rtol * max(abs(v), 1e-12), (k, got, want)


def test_coco30k_fid_clip_cli_matches_the_jax_script(tree, inception,
                                                     tiny_towers):
    """``runners.evaluate coco30k_fid_clip`` against the root
    evaluate_coco30k_fid_clip.py on the same tree and weights:
    metrics_org_coco30k_10k.yaml (FID, KID, log-KID) and
    metrics_clip_score.yaml at the same paths, the same keys and counts,
    the numbers within 1e-4 relative (FID 1e-3: sqrtm of a rank-2
    product)."""
    from threadpoolctl import threadpool_limits
    run, refs, csv = tree
    clip_dir, _, _ = tiny_clip_dir(run.parent.parent / "clip")
    argv = ["--sample_dir", str(run), "--dataset_root", str(refs),
            "--prompts_csv", str(csv), "--inception_weights", inception[2],
            "--clip_weights_dir", clip_dir]
    # one BLAS thread, so the two 2048^2 sqrtm calls do not contend for
    # every core with the suite's other workers (158 s under the suite
    # with scipy's default threads, 28 s alone)
    with threadpool_limits(1):
        j_cli_fid.main(argv)
        want = {n: _yaml(run.parent / n)[1]
                for n in ("metrics_org_coco30k_10k.yaml",
                          "metrics_clip_score.yaml")}
        t_evaluate.main(["coco30k_fid_clip", *argv, "--device", "cpu"])
    _check_yaml_pair(run, "metrics_org_coco30k_10k.yaml",
                     want["metrics_org_coco30k_10k.yaml"], rtol=1e-3)
    _check_yaml_pair(run, "metrics_clip_score.yaml",
                     want["metrics_clip_score.yaml"])
    assert want["metrics_clip_score.yaml"]["n"] == 3


def test_inception_score_matches_jax(tree, inception):
    run, _, _ = tree
    want = j_offline.evaluate_inception_score(str(run), inception[2])
    got = t_offline.evaluate_inception_score(str(run), inception[2],
                                             device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= RTOL * max(abs(want[k]), 1.0), k
    text, parsed = _yaml(run.parent / "metrics_is.yaml")
    assert parsed == got and text == yaml.dump(got)


def test_copro_aes_clip_cli_matches_the_jax_script(tree, tiny_towers):
    """``runners.evaluate copro_aes_clip`` against the root
    evaluate_copro_aes_clip.py: the AES MLP (a torch .pth with the
    layers.{0,2,4,6,7} names) on the tiny tower's embeddings, and
    CLIPScore keyed by CoPro's idx / unsafe_prompt columns."""
    run, _, _ = tree
    root = run.parent.parent
    clip_dir, vsd, _ = tiny_clip_dir(root / "clip")
    vision = root / "vision.safetensors"
    save_file(vsd, str(vision))
    torch.manual_seed(5)
    mlp = torch.nn.Sequential(
        torch.nn.Linear(16, 1024), torch.nn.Dropout(), torch.nn.Linear(
            1024, 128), torch.nn.Dropout(), torch.nn.Linear(128, 64),
        torch.nn.Dropout(), torch.nn.Linear(64, 16), torch.nn.Linear(16, 1))
    aes = root / "aes.pth"
    torch.save({f"layers.{k}": v for k, v in mlp.state_dict().items()}, aes)
    csv = root / "copro.csv"
    csv.write_text("idx,unsafe_prompt,safe_prompt\n11,a cat,x\n"
                   "13,a bird,y\n")
    argv = ["--sample_dir", str(run), "--prompts_csv", str(csv),
            "--aes_weights", str(aes), "--clip_vision_weights", str(vision),
            "--clip_weights_dir", clip_dir]
    j_cli_aes.main(argv)
    want = {n: _yaml(run.parent / n)[1]
            for n in ("metrics_aes.yaml", "metrics_clip_score.yaml")}
    t_evaluate.main(["copro_aes_clip", *argv, "--device", "cpu"])
    for name, w in want.items():
        _check_yaml_pair(run, name, w)
    assert want["metrics_clip_score.yaml"]["n"] == 2
    assert want["metrics_aes.yaml"]["n"] == 3


@pytest.mark.parametrize("layout", ["openclip", "hf"])
def test_image_similarity_matches_jax(tree, tiny_towers, layout):
    """The coco_open_clip image-image similarity (ViT-H-14's slot holding
    the tiny tower) from an OpenCLIP-layout file or an HF one, matched by
    stem: 3 pairs, the reference embedding computed once per id."""
    run, refs, _ = tree
    _, vsd, _ = tiny_clip_dir(run.parent.parent / "clip")
    path = run.parent.parent / f"{layout}.safetensors"
    save_file(to_open_clip(vsd) if layout == "openclip" else vsd, str(path))
    kw = dict(openclip_layout=layout == "openclip")
    want = j_offline.evaluate_image_similarity(str(run), str(refs),
                                               str(path), **kw)
    got = t_offline.evaluate_image_similarity(str(run), str(refs),
                                              str(path), device="cpu", **kw)
    assert got["n"] == want["n"] == 3
    assert abs(got["image_clip_similarity"]
               - want["image_clip_similarity"]) <= 1e-5
    text, parsed = _yaml(run.parent / "metrics_img_sim.yaml")
    assert parsed == got and text == yaml.dump(got)


def test_style_score_matches_jax(tree, tiny_towers):
    """Gram-matrix style distances of 3 samples to 2 targets."""
    run, refs, _ = tree
    _, vsd, _ = tiny_clip_dir(run.parent.parent / "clip")
    path = run.parent.parent / "vision.safetensors"
    save_file(vsd, str(path))
    targets = [str(refs / "11.png"), str(refs / "99.png")]
    want = j_offline.evaluate_style_score(str(run), targets, str(path))
    got = t_offline.evaluate_style_score(str(run), targets, str(path),
                                         device="cpu")
    assert got["n"] == want["n"] == 6
    assert abs(got["style_score"] - want["style_score"]) <= \
        RTOL * abs(want["style_score"])
    text, parsed = _yaml(run.parent / "metrics_style.yaml")
    assert parsed == got and text == yaml.dump(got)
    h = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    _close(t_offline.style_gram_embedding(h).numpy(),
           j_offline.style_gram_embedding(h.numpy()))


def test_in_loop_clip_score_matches_jax(tmp_path, tiny_towers):
    """InLoopClipScore on the tiny towers from an HF directory: the score
    of uint8 images (224^2, and 48^2 through the bicubic resize) against
    prompts, the port's within 1e-4 relative of the JAX package's."""
    from safe_denoiser_tpu.runners.coco30k import InLoopClipScore as JScore
    clip_dir, _, _ = tiny_clip_dir(tmp_path / "clip")
    t_scorer = t_coco.InLoopClipScore(clip_dir, device="cpu")
    j_scorer = JScore(clip_dir)
    rs = np.random.RandomState(4)
    for side, prompt in ((224, "a cat"), (48, "a dog on the beach")):
        img = rs.randint(0, 256, (side, side, 3), dtype=np.uint8)
        want = j_scorer(img, prompt)
        got = t_scorer(img, prompt)
        assert abs(got - want) <= RTOL * max(abs(want), 1.0), (got, want)
    if not torch.cuda.is_available():      # cuda unless asked, no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_coco.InLoopClipScore(clip_dir)
