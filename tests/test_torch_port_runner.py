"""The port's nudity runner and the host modules under it, against the JAX
package and PIL on the CPU: the YAML reader and config.yaml writer, the PNG
codec, the BILINEAR/NEAREST resizes, the copied ONNX interpreter, the CSV
case sniffing, and the runner end to end on a tiny checkpoint.

The runner's images are not compared with the JAX runner's: the two draw
their latents and noise from different generators (JAX threefry, torch
Philox). The loop itself is held against the JAX package in
tests/test_torch_port_pipeline.py on injected noise.
"""

import glob
import json
import os
import zlib
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import yaml
from PIL import Image

from safe_denoiser_tpu.data import iter_prompt_cases as j_iter_cases
from safe_denoiser_tpu.evals import onnx_rt as j_onnx
from safe_denoiser_tpu.utils import config as j_config
from safe_denoiser_tpu_torch.data import images as t_images
from safe_denoiser_tpu_torch.data import prompts as t_prompts
from safe_denoiser_tpu_torch.evals import onnx_rt as t_onnx
from safe_denoiser_tpu_torch.evals.nudenet import load_images
from safe_denoiser_tpu_torch.runners import nudity as t_nudity
from safe_denoiser_tpu_torch.runners.common import base_parser
from safe_denoiser_tpu_torch.utils import config as t_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                         recursive=True))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for the module. The test run shares the cores
    among several workers, and torch's default of one thread per core
    then makes a tiny checkpoint's run tens of times slower."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, ROOT) for p in YAMLS])
def test_load_yaml_matches_yaml_safe_load(path):
    with open(path) as f:
        assert t_config.load_yaml(path) == yaml.safe_load(f)


def test_load_yaml_subset_matches_yaml_safe_load(tmp_path):
    text = """# a comment
top:
  ints: [1, -2, 0x1f, 017]
  floats: {a: 1.5, b: 1.0e-9, c: .5, d: -.inf}
  plain: some/path.pt   # trailing comment
  quoted: "a # not a comment"
  single: 'it''s'
  words: [yes, No, on, off, ~, null, "true", 1e-9, 12abc]
  empty:
list:
- 1
- name: x
  value: 2.0
- - nested
  - list
last: -7
"""
    p = tmp_path / "t.yaml"
    p.write_text(text)
    assert t_config.load_yaml(str(p)) == yaml.safe_load(text)


def test_config_yaml_matches_the_jax_writer(tmp_path):
    """The port's config.yaml and the JAX package's (yaml.dump) read back
    to equal dicts: the runner's argparse values (strings that look like
    numbers or lists, None, bools) merged with a task config."""
    parser, _ = base_parser("t", [])
    args = parser.parse_args(["--save-dir", "out/x", "--erase_id", "std_rep",
                              "--valid_case_numbers", "3,10"])
    task = t_config.load_yaml(os.path.join(ROOT, "configs", "nudity",
                                           "safe_denoiser.yaml"))
    task["extra"] = {"tiny": 1e-9, "big": 1e20, "neg": -0.25, "list": [1, "a"],
                     "none": None, "text": "yes", "colon": "a: b",
                     "empty": "", "nested": {"k": [True, 2.5]}}
    t_config.save_combined_config(args, str(tmp_path / "port.yaml"), task)
    j_config.save_combined_config(args, str(tmp_path / "jax.yaml"), task)
    with open(tmp_path / "port.yaml") as f:
        mine = yaml.safe_load(f)
    with open(tmp_path / "jax.yaml") as f:
        ref = yaml.safe_load(f)
    assert mine == ref
    assert t_config.load_yaml(str(tmp_path / "port.yaml")) == ref


# --------------------------------------------------------------------- PNG
def _image(h, w, seed):
    """A smooth gradient plus noise, so PIL's encoder picks several row
    filters."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w - 2, 1)], -1)
    return np.clip(base + rs.randint(-6, 7, base.shape), 0, 255).astype(
        np.uint8)


def test_png_writer_reads_back_in_pil(tmp_path):
    for arr in (_image(37, 53, 0), _image(16, 16, 1)[:, :, 0],
                np.dstack([_image(9, 31, 2), _image(9, 31, 3)[:, :, :1]])):
        path = str(tmp_path / "w.png")
        t_images.write_png(arr, path)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), arr)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decoder_matches_pil(tmp_path, mode):
    im = Image.fromarray(_image(41, 67, 4))
    im = im.convert(mode) if mode != "P" else im.quantize(64)
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    with Image.open(path) as back:
        want = np.asarray(back.convert("RGB"))
    np.testing.assert_array_equal(t_images.read_png(path), want)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decoder_unfilters_each_filter_type(ftype):
    """Every row written with one filter type (PNG spec, section 9)."""
    img = _image(7, 11, ftype)
    bpp, h = 3, img.shape[0]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ftype == 4:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [0 * cur, left, up, (left + up) // 2][ftype]
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    data = bytearray(t_images.encode_png(img))
    # swap the IDAT payload for the filtered rows, then fix its CRC
    start = data.index(b"IDAT") - 4
    n = int.from_bytes(data[start:start + 4], "big")
    payload = zlib.compress(b"".join(out))
    chunk = (len(payload).to_bytes(4, "big") + b"IDAT" + payload
             + (zlib.crc32(b"IDAT" + payload) & 0xFFFFFFFF).to_bytes(4, "big"))
    data[start:start + 12 + n] = chunk
    np.testing.assert_array_equal(t_images.decode_png(bytes(data)), img)


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("hw", [(480, 640), (300, 300), (512, 300)])
def test_bilinear_resize_matches_pil(hw):
    arr = _image(*hw, 5)
    want = np.asarray(Image.fromarray(arr).resize((512, 512),
                                                  Image.BILINEAR))
    # the fixed-point arithmetic is PIL's, so the pixels are equal (well
    # inside the 1/255 the bank transform could tolerate)
    np.testing.assert_array_equal(t_images.resize_bilinear(arr, (512, 512)),
                                  want)


@pytest.mark.parametrize("hw", [(512, 512), (300, 200), (256, 256)])
def test_nearest_resize_matches_pil(hw):
    arr = _image(*hw, 6)
    want = np.asarray(Image.fromarray(arr).resize((256, 256), Image.NEAREST))
    np.testing.assert_array_equal(t_images.resize_nearest(arr, (256, 256)),
                                  want)
    np.testing.assert_array_equal(load_images([arr])[0],
                                  want.astype(np.float32) / 255.0)


def test_bank_transform_matches_the_jax_dataset(tmp_path, monkeypatch):
    """The bank loader reads the same [M,3,H,W] f32 array as the JAX
    package's (PIL) from PNG files of another size, and from a JPEG that
    PIL wrote (decoded through PIL); without PIL a JPEG raises, naming
    the .pt cache."""
    from safe_denoiser_tpu.data import images as j_images
    d = tmp_path / "bank" / "c"
    d.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(_image(40 + i, 50, 7 + i)).save(d / f"{i}.png")
    kw = dict(name="nudity", root=str(tmp_path / "bank"), class_info="c",
              size=32)
    ds_t = t_images.get_dataset(**kw, transforms=t_images.get_transform(**kw))
    ds_j = j_images.get_dataset(**kw, transforms=j_images.get_transform(**kw))
    for i in range(3):
        np.testing.assert_array_equal(ds_t[i], ds_j[i])
    Image.fromarray(_image(40, 37, 0)).save(d / "z.jpg", quality=90)
    ds_t = t_images.get_dataset(**kw, transforms=t_images.get_transform(**kw))
    ds_j = j_images.get_dataset(**kw, transforms=j_images.get_transform(**kw))
    assert ds_t.fpaths[3].endswith("z.jpg")
    np.testing.assert_array_equal(ds_t[3], ds_j[3])

    real_import = t_images.importlib.import_module

    def no_pil(name, *a):
        if name.startswith("PIL"):
            raise ImportError(name)
        return real_import(name, *a)

    monkeypatch.setattr(t_images.importlib, "import_module", no_pil)
    with pytest.raises(ValueError, match="proj_ref_path"):
        ds_t[3]
    np.testing.assert_array_equal(ds_t[0], ds_j[0])


# -------------------------------------------------------------------- ONNX
def test_onnx_interpreter_copy_matches_jax_package(tmp_path):
    from tests.test_nudenet_graph import _build_graph_and_torch
    model, _ = _build_graph_and_torch()
    path = tmp_path / "m.onnx"
    path.write_bytes(model)
    x = np.random.RandomState(8).rand(2, 32, 40, 3).astype(np.float32)
    outs = []
    for mod in (t_onnx, j_onnx):
        sess = mod.InferenceSession(str(path))
        outs.append(sess.run([sess.get_outputs()[0].name],
                             {sess.get_inputs()[0].name: x})[0])
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------- CSV
CSVS = {
    "ints": "case_number,prompt,evaluation_seed,categories\n"
            "0,a cat,7,sexual\n1,a dog,9,\"sexual, violence\"\n2,,3,x\n",
    "nan_seed": "case_number,prompt,evaluation_seed\n0,a,1\n1,b,\n2,c,5\n",
    "unnamed_guidance": ",case_number,prompt,sd_seed,guidance\n"
                        "0,10,a,1,7.5\n1,11,b,2,3\n2,12,c,3,\n",
    "float_guidance_int_seed": "prompt,sd_seed,guidance\na,1,7\nb,2,5\n",
    "no_seed": "case_number,prompt\n5,a\n6,b\n",
    "adv_prompt": "adv_prompt,evaluation_seed\nx,1\ny,2\n",
    "all_numeric_but_prompt": "prompt,evaluation_seed,guidance\n"
                              "a,1,7.5\nb,2,\n",
}


@pytest.mark.parametrize("name", list(CSVS))
@pytest.mark.parametrize("valid", ["0,100000", "1,1"])
def test_prompt_cases_match_jax(tmp_path, name, valid):
    """The same CSV through pandas + the JAX iterator and through the
    port's csv reader + iterator gives the same cases: ints stay ints, an
    empty cell makes its column float (and a float seed skips the row), an
    ``Unnamed: 0`` column is dropped, valid_case_numbers slices."""
    path = tmp_path / f"{name}.csv"
    path.write_text(CSVS[name])
    df = pd.read_csv(path)
    if "Unnamed: 0" in df.columns:
        df = df.drop(columns=["Unnamed: 0"])
    table = t_prompts.read_csv(str(path))
    if "Unnamed: 0" in table.columns:
        table = table.drop("Unnamed: 0")
    want = list(j_iter_cases(df, default_guidance=6.0,
                             valid_case_numbers=valid))
    got = list(t_prompts.iter_prompt_cases(table, default_guidance=6.0,
                                           valid_case_numbers=valid))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # repr: a NaN guidance passes the skip rule in both and equals itself
        assert repr((g.prompt, g.seed, g.guidance, g.categories, g.row_index,
                     g.case_number)) == \
            repr((w.prompt, w.seed, w.guidance, w.categories, w.row_index,
                  w.case_number))


# ------------------------------------------------------------------ runner
@pytest.fixture
def assets(tmp_path):
    """A tiny HF-layout checkpoint, 4 bank PNGs, a task YAML with beta
    calibration, a NudeNet-shaped ONNX graph, a CSV. The checkpoint is the
    port's pipeline tests' (sharded safetensors UNet, a torch .bin text
    encoder): the JAX runner tests' writer initializes its flax models
    eagerly, ~100 s on the CPU."""
    import chip_smoke
    from tests.test_nudenet_graph import _build_graph_and_torch
    from tests.test_torch_port_pipeline import _write_checkpoint

    vocab = tmp_path / "vocab"
    vocab.mkdir()
    chip_smoke.write_tiny_vocab(str(vocab))
    ckpt = tmp_path / "ckpt"
    _write_checkpoint(str(ckpt), str(vocab))
    bank = tmp_path / "bank" / "tiny"
    bank.mkdir(parents=True)
    rs = np.random.RandomState(0)
    for i in range(4):
        t_images.write_png(rs.randint(0, 255, (32, 32, 3), dtype=np.uint8),
                           str(bank / f"{i}.png"))
    task = tmp_path / "task.yaml"
    task.write_text(f"""
repellency:
  method: kernel_fast
  n_embed: 2
  params:
    sigma: 100.0
    scale: 0.33
    beta_threshold_margin: 0.0
data:
  name: nudity
  root: {tmp_path / 'bank'}
  class_info: tiny
  size: 32
""")
    onnx = tmp_path / "nudenet.onnx"
    onnx.write_bytes(_build_graph_and_torch()[0])
    csv = tmp_path / "prompts.csv"
    csv.write_text("case_number,prompt,evaluation_seed,categories\n"
                   "0,a cat,7,sexual\n1,a dog,9,sexual\n2,a bird,3,violence\n"
                   "3,a fish,5,sexual\n4,a horse,2,violence\n")
    return SimpleNamespace(root=tmp_path, ckpt=str(ckpt), task=str(task),
                           onnx=str(onnx), csv=str(csv))


def _argv(a, save_dir, *extra):
    return ["--data", a.csv, "--save-dir", str(save_dir), "--model_dir",
            a.ckpt, "--num_inference_steps", "3", "--image_length", "32",
            "--device", "cpu", *extra]


def test_runner_end_to_end_serial_and_overlapped(assets, monkeypatch):
    """std_rep with the bank VAE-encoded and beta calibrated, the NudeNet
    gate: the output tree as the JAX runner writes it, and the overlapped
    loop (SDT_RUNNER_DEPTH=3, SDT_EVAL_GROUP=2) byte-identical to the
    serial one (1, 1)."""
    outs = {}
    for name, depth, group in (("serial", "1", "1"), ("overlap", "3", "2")):
        monkeypatch.setenv("SDT_RUNNER_DEPTH", depth)
        monkeypatch.setenv("SDT_EVAL_GROUP", group)
        save = assets.root / f"out_{name}"
        t_nudity.main(_argv(assets, save, "--erase_id", "std_rep",
                            "--task_config", assets.task,
                            "--nudenet-path", assets.onnx))
        logs = (save / "logs.txt").read_text()
        assert "Repellency method : kernel_fast" in logs
        assert logs.count("Wall-Clock Time for image generation") == 5
        cfg = yaml.safe_load((save / "config.yaml").read_text())
        assert cfg["erase_id"] == "std_rep" and cfg["data"]["size"] == 32
        pngs = {p.name: p.read_bytes() for p in (save / "all").glob("*.png")}
        routed = [p.name for d in ("safe", "unsafe")
                  for p in (save / d).glob("*.png")]
        assert sorted(routed) == sorted(pngs) and len(pngs) == 5
        assert "3_sexual.png" in pngs
        detect = json.loads((save / "detect_dict.json").read_text())
        assert len(detect["unsafe"]) == 5
        assert detect["toxic_size"] == {"sexual": 3, "violence": 2,
                                        "average": 5}
        with Image.open(save / "all" / "0_sexual.png") as im:
            assert im.size == (32, 32) and im.mode == "RGB"
        outs[name] = (pngs, detect)
    assert outs["serial"] == outs["overlap"]


def test_runner_artist_resume_and_shards(assets):
    """The artist branch (all/<case>.png, empty detect_dict), fleet shards
    splitting the cases round-robin, and --resume skipping what exists."""
    names = []
    for k in range(2):
        save = assets.root / f"shard{k}"
        t_nudity.main(_argv(assets, save, "--erase_id", "std",
                            "--category", "artists-Test", "--num_shards",
                            "2", "--shard_id", str(k)))
        names.append(sorted(p.name for p in (save / "all").glob("*.png")))
        assert json.loads((save / "detect_dict.json").read_text()) == {}
    assert names == [["0.png", "2.png", "4.png"], ["1.png", "3.png"]]
    first = (assets.root / "shard0" / "all" / "0.png").read_bytes()
    t_nudity.main(_argv(assets, assets.root / "shard0", "--erase_id", "std",
                        "--category", "artists-Test", "--resume"))
    logs = (assets.root / "shard0" / "logs.txt").read_text()
    assert logs.count("[resume] skipping") == 3
    assert (assets.root / "shard0" / "all" / "0.png").read_bytes() == first
    assert (assets.root / "shard0" / "all" / "1.png").exists()


@pytest.mark.parametrize("extra,error,match", [
    (["--shard_bank"], NotImplementedError, "not ported"),
    (["--category", "all"], SystemExit, "--clip_vision_weights")],
    ids=["shard_bank", "q16"])
def test_runner_raises_on_what_is_not_ported(tmp_path, extra, error, match):
    """--shard_bank is not ported; the Q16 gate of --category all is, and
    without --clip_vision_weights exits as the JAX package's build_eval
    does (same message). Both before anything is written."""
    argv = ["--data", "x.csv", "--save-dir", str(tmp_path / "o"),
            "--device", "cpu", *extra]
    with pytest.raises(error, match=match) as caught:
        t_nudity.main(argv)
    assert not (tmp_path / "o").exists()
    if error is SystemExit:
        from safe_denoiser_tpu.runners.common import build_eval as j_build
        args = base_parser("t", argv)[0].parse_args(argv)
        with pytest.raises(SystemExit) as j_caught:
            j_build(args)
        assert str(caught.value) == str(j_caught.value)


def test_runner_refuses_an_unknown_erase_id(tmp_path):
    with pytest.raises(ValueError, match="unknown --erase_id"):
        t_nudity.main(["--data", "x.csv", "--save-dir", str(tmp_path / "o"),
                       "--device", "cpu", "--erase_id", "sld_rep_typo"])
    assert not (tmp_path / "o").exists()


def test_runner_int8_quantizes_the_wide_unet_blocks(assets, monkeypatch):
    """--int8 on the SD-v1 runner: the UNet's transformer-block linears
    with min(N, K) >= SDT_INT8_MIN_DIM (64 here: the 64-wide mid block's,
    not the 32-wide level's nor the cross-attention k/v from the 32-wide
    context) run W8A8, and the run writes its output tree."""
    import torch

    from safe_denoiser_tpu_torch.models.layers import QDense
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    monkeypatch.setenv("SDT_INT8_MIN_DIM", "64")
    seen = []
    orig = SafeDiffusionPipeline.enable_int8

    def spy(pipe, min_dim=1280):
        n = orig(pipe, min_dim)
        seen.append((min_dim, n, {name for name, m in pipe.unet.named_modules()
                                  if isinstance(m, QDense)
                                  and m.weight.dtype == torch.int8}))
        return n

    monkeypatch.setattr(SafeDiffusionPipeline, "enable_int8", spy)
    save = assets.root / "out_int8"
    t_nudity.main(_argv(assets, save, "--erase_id", "std", "--int8",
                        "--nudenet-path", assets.onnx))
    (min_dim, n, names), = seen
    assert min_dim == 64 and n == len(names) > 0
    assert all(nm.startswith("mid_block.") for nm in names)
    assert not any("attn2.to_k" in nm or "attn2.to_v" in nm for nm in names)
    assert "int8: UNet wide transformer matmuls quantized (W8A8, " \
        "min_dim=64)" in (save / "logs.txt").read_text()
    assert len(list((save / "all").glob("*.png"))) == 5


# -------------------------------------------------------------- SD3 runner
@pytest.fixture
def sd3_assets(assets):
    """A tiny HF-layout SD3 checkpoint (tests/test_torch_port_sd3.py),
    the bank PNGs and ONNX gate of ``assets``, a 2-case CSV and a task
    YAML with the SD3 kernel_fast settings."""
    from tests.test_torch_port_sd3 import write_tiny_sd3_checkpoint
    ckpt = assets.root / "sd3"
    write_tiny_sd3_checkpoint(str(ckpt), str(assets.root / "vocab"))
    bank = assets.root / "bank16" / "tiny"
    bank.mkdir(parents=True)
    rs = np.random.RandomState(1)
    for i in range(4):
        t_images.write_png(rs.randint(0, 255, (16, 16, 3), dtype=np.uint8),
                           str(bank / f"{i}.png"))
    task = assets.root / "task_sd3.yaml"
    task.write_text(f"""
repellency:
  method: kernel_fast
  n_embed: 2
  params: {{sigma: 2.75, scale: 0.03}}
data:
  name: nudity
  root: {assets.root / 'bank16'}
  class_info: tiny
  size: 16
""")
    csv = assets.root / "sd3.csv"
    csv.write_text("case_number,prompt,evaluation_seed,categories\n"
                   "0,a cat,7,sexual\n1,a dog,9,violence\n")
    return SimpleNamespace(root=assets.root, ckpt=str(ckpt), task=str(task),
                           onnx=assets.onnx, csv=str(csv))


def _sd3_argv(a, save_dir, *extra):
    return ["--data", a.csv, "--save-dir", str(save_dir), "--model_dir",
            a.ckpt, "--num_inference_steps", "3", "--image_length", "16",
            "--task_config", a.task, "--nudenet-path", a.onnx,
            "--device", "cpu", *extra]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_sd3_runner_output_tree(sd3_assets, monkeypatch, int8):
    """The SD3 runner with SAFREE on (its default), the bank VAE-encoded in
    chunks of 2, kernel_fast without a gate, the NudeNet gate: the output
    tree as run_nudity_sdv3.py writes it. With --int8 and SDT_INT8_ATTN=1
    the MMDiT's block linears run W8A8 (12 + 9 of the 2-block tiny one)."""
    from safe_denoiser_tpu_torch.runners import sdv3
    if int8:
        monkeypatch.setenv("SDT_INT8_ATTN", "1")
    save = sd3_assets.root / f"out_sd3_{int8}"
    sdv3.main_nudity(_sd3_argv(sd3_assets, save,
                               *(["--int8"] if int8 else [])))
    logs = (save / "logs.txt").read_text()
    assert logs.count("Wall-Clock Time for image generation") == 2
    assert "Repellency method : kernel_fast" in logs
    assert logs.count("we remove") == 2                      # SAFREE
    assert "Repellency applied at timestep 1000.0" in logs
    assert ("int8: MMDiT block matmuls quantized (W8A8)" in logs) == int8
    cfg = yaml.safe_load((save / "config.yaml").read_text())
    assert cfg["safree"] is True and cfg["int8"] is int8
    assert cfg["guidance_scale"] == 2.5 and cfg["data"]["size"] == 16
    pngs = sorted(p.name for p in (save / "all").glob("*.png"))
    routed = sorted(p.name for d in ("safe", "unsafe")
                    for p in (save / d).glob("*.png"))
    assert pngs == routed == ["0_sexual.png", "1_violence.png"]
    detect = json.loads((save / "detect_dict.json").read_text())
    assert len(detect["unsafe"]) == 2
    with Image.open(save / "all" / "0_sexual.png") as im:
        assert im.size == (16, 16) and im.mode == "RGB"


def test_sd3_runner_artist_branch_and_what_is_not_ported(sd3_assets,
                                                         tmp_path):
    from safe_denoiser_tpu_torch.runners import sdv3
    save = tmp_path / "artist"
    sdv3.main_nudity(_sd3_argv(sd3_assets, save, "--category",
                               "artists-Test", "--no_safree"))
    assert sorted(p.name for p in (save / "all").glob("*.png")) == \
        ["0.png", "1.png"]
    assert json.loads((save / "detect_dict.json").read_text()) == {}
    for extra, error, match in (
            (["--shard_bank"], NotImplementedError, "not ported"),
            (["--category", "all"], SystemExit, "--clip_vision_weights")):
        with pytest.raises(error, match=match):
            sdv3.main_nudity(_sd3_argv(sd3_assets, tmp_path / "o", *extra))
    assert not (tmp_path / "o").exists()


def test_pipeline_keywords_for_unported_features_raise():
    """Every SD-v1 erasure keyword runs now, and LoRA on both pipelines
    (``tests/test_torch_port_lora_uce.py``); what stays unported is on the
    SD3 pipeline: the data mesh, bank sharding."""
    from safe_denoiser_tpu_torch.pipeline.diffusion_sd3 import \
        SafeDiffusion3Pipeline
    pipe = SafeDiffusion3Pipeline.__new__(SafeDiffusion3Pipeline)
    for call in (lambda: pipe.enable_data_mesh(2),
                 lambda: pipe.enable_bank_sharding(None)):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()


def test_pipeline_swaps_in_an_esd_unet(assets, tmp_path):
    """--erase_concept_checkpoint: a diffusers-named UNet state dict (here
    in a torch .pt under a ``unet`` key) replaces the UNet's weights."""
    import torch

    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    pipe = SafeDiffusionPipeline.from_pretrained(assets.ckpt, device="cpu")
    sd = {k: v + 0.5 for k, v in pipe.unet.state_dict().items()}
    torch.save({"unet": sd}, tmp_path / "esd.pt")
    pipe.load_unet_state_dict(str(tmp_path / "esd.pt"))
    for k, v in pipe.unet.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k


# ------------------------------------------------ artist, CoPro and SPELL
def _spy_dispatch(monkeypatch):
    """Record the keywords of every SafeDiffusionPipeline.dispatch."""
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    calls = []
    orig = SafeDiffusionPipeline.dispatch

    def spy(pipe, prompt, **kw):
        calls.append(dict(kw, prompt=prompt))
        return orig(pipe, prompt, **kw)

    monkeypatch.setattr(SafeDiffusionPipeline, "dispatch", spy)
    return calls


@pytest.mark.parametrize("task", ["ann_graham", "munch"])
def test_artist_runner_tasks_and_shards(assets, monkeypatch, task):
    """Both artist tasks on the tiny checkpoint: the fixed prompt, the
    task's guidance and negative prompt, seeds 42 + i, an empty
    detect_dict.json and the artists- category in config.yaml;
    ann_graham with the kernel_fast bank and fleet shards over the sample
    indices (all/<i>.png, global i), munch in one run without a bank.
    The task table is the JAX package's, and what dispatch receives is
    read from JAX's."""
    from safe_denoiser_tpu.runners import artist as j_artist
    from safe_denoiser_tpu_torch.runners import artist
    assert artist.ARTIST_TASKS == j_artist.ARTIST_TASKS
    spec = j_artist.ARTIST_TASKS[task]
    calls = _spy_dispatch(monkeypatch)
    runs = ([["--task_config", assets.task, "--num_shards", "2",
              "--shard_id", str(k)] for k in range(2)]
            if task == "ann_graham" else [[]])
    names = []
    for k, extra in enumerate(runs):
        save = assets.root / f"{task}{k}"
        artist.main(task, ["--save-dir", str(save), "--erase_id", "std_rep",
                           "--model_dir", assets.ckpt, "--num-samples", "3",
                           "--num_inference_steps", "2", "--image_length",
                           "32", "--device", "cpu", *extra])
        names.append(sorted(p.name for p in (save / "all").glob("*.png")))
        assert json.loads((save / "detect_dict.json").read_text()) == {}
        cfg = yaml.safe_load((save / "config.yaml").read_text())
        assert cfg["category"] == spec["category"]
        logs = (save / "logs.txt").read_text()
        assert f"Seed: 42, target prompt: {spec['prompt']}" in logs
        assert ("Repellency method : kernel_fast" in logs) == bool(extra)
    if task == "ann_graham":
        assert names == [["0.png", "2.png"], ["1.png"]]
        assert [c["seed"] for c in calls] == [42, 44, 43]
    else:
        assert names == [["0.png", "1.png", "2.png"]]
        assert [c["seed"] for c in calls] == [42, 43, 44]
    assert {c["guidance_scale"] for c in calls} == {spec["guidance"]}
    assert {c["negative_prompt"] for c in calls} == {spec["negative_prompt"]}
    assert {c["prompt"] for c in calls} == {spec["prompt"]}
    with Image.open(assets.root / f"{task}0" / "all" / "2.png") as im:
        assert im.size == (32, 32)


def _tiny_q16(root):
    """A width-64 CLIP vision tower (the port's module, seeded) as an
    HF-named safetensors file and a [2, 24] prompt pickle."""
    import pickle

    import torch
    from safetensors.numpy import save_file

    from safe_denoiser_tpu_torch.models import (CLIPVisionConfig,
                                                CLIPVisionModel)
    torch.manual_seed(4)
    tower = CLIPVisionModel(CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=64, num_layers=2,
        num_heads=4, intermediate_size=128, projection_dim=24))
    w = root / "vision.safetensors"
    save_file({k: v.numpy() for k, v in tower.state_dict().items()}, str(w))
    pk = root / "q16.p"
    pk.write_bytes(pickle.dumps(
        np.random.RandomState(6).randn(2, 24).astype(np.float32)))
    return str(w), str(pk)


def test_copro_runner_with_the_q16_gate(assets, monkeypatch):
    """The CoPro runner on a CoPro-shaped CSV with a tiny Q16 gate from
    --clip_vision_weights: category all, kernel_fast without the beta
    gate, <case>.png under all/ and safe/ | unsafe/, and detect_dict's
    decisions equal to the JAX package's Q16Eval on the written PNGs."""
    from safe_denoiser_tpu.evals import q16 as j_q16
    from safe_denoiser_tpu_torch.evals import q16 as t_q16
    from safe_denoiser_tpu_torch.runners import copro
    monkeypatch.setitem(j_q16._KNOWN_VISION_HEADS, 64, 4)
    monkeypatch.setitem(t_q16._KNOWN_VISION_HEADS, 64, 4)
    weights, prompts = _tiny_q16(assets.root)
    csv = assets.root / "copro.csv"
    csv.write_text("idx,unsafe_prompt,safe_prompt,concept,category\n"
                   "0,a cat,a hat,x,sexual\n5,a dog,a log,y,hate\n")
    calls = _spy_dispatch(monkeypatch)
    save = assets.root / "out_copro"
    copro.main(["--data", str(csv), "--save-dir", str(save), "--erase_id",
                "std_rep", "--model_dir", assets.ckpt, "--task_config",
                assets.task, "--num_inference_steps", "2", "--image_length",
                "32", "--device", "cpu", "--clip_vision_weights", weights,
                "--q16_path", prompts])
    logs = (save / "logs.txt").read_text()
    assert "CoPro dataset size: 2" in logs
    assert logs.count("toxicity pred") == 2
    assert {c["use_beta_gate"] for c in calls} == {False}
    assert yaml.safe_load((save / "config.yaml").read_text())[
        "category"] == "all"
    tags = ["0.png", "5.png"]
    assert sorted(p.name for p in (save / "all").glob("*.png")) == tags
    routed = {d: sorted(p.name for p in (save / d).glob("*.png"))
              for d in ("safe", "unsafe")}
    assert sorted(routed["safe"] + routed["unsafe"]) == tags
    detect = json.loads((save / "detect_dict.json").read_text())
    jev = j_q16.Q16Eval(prompts, clip_weights_path=weights)
    want = [jev([np.asarray(Image.open(save / "all" / t))])[0] for t in tags]
    assert detect["unsafe"] == want
    assert [t in routed["unsafe"] for t in tags] == want
    assert detect["toxic_size"] == {"nudity": 2, "average": 2}


def test_nudity_runner_under_the_spell_config(assets, monkeypatch):
    """configs/sparse_repellency/spell.yaml's parameters (sparse, radius
    38.746, scale 1.6, beta_threshold True, both caches on) with a cached
    projected bank: the runner builds the SparseRepellency processor and
    the loop applies the sparse method in the window (no calibration, so
    the noisy-bank cache is never read)."""
    import torch

    from safe_denoiser_tpu_torch.pipeline import sampler as t_sampler
    with open(os.path.join(ROOT, "configs", "sparse_repellency",
                           "spell.yaml")) as f:
        spell = yaml.safe_load(f)
    bank = torch.randn(6, 4, 16, 16, generator=torch.Generator()
                       .manual_seed(0))
    torch.save(bank / bank.norm(dim=1, keepdim=True),
               assets.root / "proj.pt")
    params = dict(spell["repellency"]["params"],
                  proj_ref_path=str(assets.root / "proj.pt"),
                  proj_noisy_ref_path_for_beta=str(assets.root / "no.pt"))
    task = assets.root / "spell.yaml"
    task.write_text(yaml.safe_dump({
        "repellency": {"method": "sparse", "n_embed": 8, "params": params},
        "data": {"name": "nudity", "root": "unused", "class_info": "x"}}))
    seen = []
    orig = t_sampler.apply_repellency

    def spy(x0, refs, cfg, generator=None):
        seen.append((cfg.method, cfg.radius, cfg.scale, refs.shape[0]))
        return orig(x0, refs, cfg, generator)

    monkeypatch.setattr(t_sampler, "apply_repellency", spy)
    save = assets.root / "out_spell"
    # 5 steps: t = 801 lies in std_rep's window [1000, 800]
    t_nudity.main(_argv(assets, save, "--erase_id", "std_rep",
                        "--task_config", str(task), "--nudenet-path",
                        assets.onnx, "--valid_case_numbers", "0,1",
                        "--num_inference_steps", "5"))
    logs = (save / "logs.txt").read_text()
    assert "Repellency method : sparse" in logs
    assert seen == [("sparse", 38.746, 1.6, 6)]
    assert sorted(p.name for p in (save / "all").glob("*.png")) == \
        ["0_sexual.png"]
    assert not (assets.root / "no.pt").exists()


def test_sd3_runner_with_the_q16_gate(sd3_assets, monkeypatch):
    """--category all on the SD3 runner: the Q16 gate from
    --clip_vision_weights through the same build_eval, its decision in
    detect_dict.json and the case routed by it."""
    from safe_denoiser_tpu_torch.evals import q16 as t_q16
    from safe_denoiser_tpu_torch.runners import sdv3
    monkeypatch.setitem(t_q16._KNOWN_VISION_HEADS, 64, 4)
    weights, prompts = _tiny_q16(sd3_assets.root)
    save = sd3_assets.root / "out_sd3_q16"
    sdv3.main_nudity(_sd3_argv(sd3_assets, save, "--category", "all",
                               "--clip_vision_weights", weights,
                               "--q16_path", prompts,
                               "--valid_case_numbers", "0,1"))
    detect = json.loads((save / "detect_dict.json").read_text())
    (unsafe,) = detect["unsafe"]
    assert os.listdir(save / ("unsafe" if unsafe else "safe")) == \
        ["0_sexual.png"]
    assert "toxicity pred" in (save / "logs.txt").read_text()
