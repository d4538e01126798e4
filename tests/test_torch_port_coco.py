"""The port's COCO-30k runners (SD-v1.4 ``runners.coco30k`` in its per-case
and batched modes, SD3 ``runners.sdv3 coco30k``) and the Recap-COCO-30K
loader against the JAX package on the CPU.

Each runner runs for real on the tiny checkpoints of
tests/test_torch_port_runner.py (2 steps): the output tree, the log lines,
``--resume``, and the in-loop CLIP scores, which the JAX package's
``InLoopClipScore`` reproduces on the written PNGs. The runners are then
held against the JAX runners line by line with one stub pipeline in both
(images from the case's seed): the two packages cannot share a noise
stream (JAX threefry, torch Philox), so only a stub gives both the same
images. What each runner passes its pipeline is compared too.
"""

import os
import re
import runpy
import warnings

import numpy as np
import pytest
import yaml
from PIL import Image

from safe_denoiser_tpu.data import iter_prompt_cases as j_iter_cases
from safe_denoiser_tpu.data import load_hf_coco_dataset as j_load_hf
from safe_denoiser_tpu.runners import coco30k as j_coco
from safe_denoiser_tpu.runners import sdv3 as j_sdv3
from safe_denoiser_tpu.runners.coco30k import InLoopClipScore as JScore
from safe_denoiser_tpu_torch.data import prompts as t_prompts
from safe_denoiser_tpu_torch.data.images import read_png
from safe_denoiser_tpu_torch.runners import coco30k as t_coco
from safe_denoiser_tpu_torch.runners import sdv3 as t_sdv3
from tests.test_torch_port_offline_eval import tiny_clip_dir, tiny_towers  # noqa: F401,E501
from tests.test_torch_port_runner import assets, sd3_assets  # noqa: F401
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

# tiny f32 CLIP towers: the two packages' scores agree to this (relative)
RTOL = 1e-4
# config.yaml keys whose values differ by design: the device, and each
# run's own directory
OWN = ("device", "save_dir")
COCO_CSV = ("coco_id,prompt,evaluation_seed,case_number\n"
            "391895,a man riding a bike,11,0\n522418,a cat on a sofa,12,1\n"
            "184613,two dogs on a beach,13,2\n")


def _log(path):
    """logs.txt without the logger's time stamps."""
    return [line.split(" - INFO - ", 1)[1]
            for line in open(path).read().splitlines() if " - INFO - " in line]


def _clip_lines(lines):
    return {m.group(1): float(m.group(2)) for m in (
        re.match(r"CLIP score \(Case#: (\S+)\): (\S+)$", line)
        for line in lines) if m}


@pytest.fixture
def coco(assets, tiny_towers):  # noqa: F811
    csv = assets.root / "coco.csv"
    csv.write_text(COCO_CSV)
    clip_dir, _, _ = tiny_clip_dir(assets.root / "clip")
    return assets, str(csv), clip_dir


def _argv(a, csv, save, *extra):
    return ["--data", csv, "--save-dir", str(save), "--model_dir", a.ckpt,
            "--num_inference_steps", "2", "--image_length", "32",
            "--device", "cpu", *extra]


def test_coco_runner_per_case_resume_and_batched(coco, monkeypatch):
    """Per case under the safe config (kernel_fast, std_rep): all/<case>.png,
    one CLIP line a case and their mean, config.yaml with the task config;
    --resume skips every case. Batched (--batch_size 2): chunks of 2 and 1
    through dispatch_batch with each row's seed, the same CLIP lines, no
    config.yaml. Every logged score is the port's InLoopClipScore on the
    written PNG, within 1e-4 of the JAX package's."""
    a, csv, clip_dir = coco
    monkeypatch.setenv("SDT_RUNNER_DEPTH", "2")
    save = a.root / "coco_case"
    t_coco.main(_argv(a, csv, save, "--clip_weights_dir", clip_dir,
                      "--task_config", a.task, "--erase_id", "std_rep"))
    lines = _log(save / "logs.txt")
    assert "coco dataset size: 3" in lines
    assert "Repellency method : kernel_fast" in lines
    assert sum(line.startswith("Wall-Clock Time for image generation")
               for line in lines) == 3
    scores = _clip_lines(lines)
    assert list(scores) == ["0", "1", "2"]
    assert re.fullmatch(r"mean CLIP score: -?[0-9.]+ over 3 images",
                        lines[-1])
    cfg = yaml.safe_load((save / "config.yaml").read_text())
    assert cfg["erase_id"] == "std_rep" and cfg["data"]["size"] == 32
    assert sorted(os.listdir(save / "all")) == ["0.png", "1.png", "2.png"]

    t_scorer = t_coco.InLoopClipScore(clip_dir, device="cpu")
    j_scorer = JScore(clip_dir)
    prompts = ["a man riding a bike", "a cat on a sofa", "two dogs on a beach"]
    for case, prompt in zip(("0", "1", "2"), prompts):
        img = read_png(str(save / "all" / f"{case}.png"))
        assert img.shape == (32, 32, 3)
        got = t_scorer(img, prompt)
        assert f"{got:.4f}" == f"{scores[case]:.4f}"
        want = j_scorer(img, prompt)
        assert abs(got - want) <= RTOL * max(abs(want), 1.0), (got, want)

    first = (save / "all" / "0.png").read_bytes()
    t_coco.main(_argv(a, csv, save, "--resume"))
    lines = _log(save / "logs.txt")
    assert sum("[resume] skipping Case#" in line for line in lines) == 3
    assert (save / "all" / "0.png").read_bytes() == first

    batched = a.root / "coco_batched"
    t_coco.main(_argv(a, csv, batched, "--clip_weights_dir", clip_dir,
                      "--batch_size", "2"))
    lines = _log(batched / "logs.txt")
    walls = [line for line in lines if line.startswith("Wall-Clock")]
    assert [w.split(":")[0] for w in walls] == [
        "Wall-Clock Time for batch of 2", "Wall-Clock Time for batch of 1"]
    assert list(_clip_lines(lines)) == ["0", "1", "2"]
    assert re.fullmatch(r"mean CLIP score: -?[0-9.]+ over 3 images",
                        lines[-1])
    assert sorted(os.listdir(batched / "all")) == ["0.png", "1.png", "2.png"]
    assert not (batched / "config.yaml").exists()


def test_coco_runner_refuses_before_writing(tmp_path, request):
    """A bad erase id and a missing CLIP directory refuse before anything
    is written. --shard_bank runs: on one device (here the CPU) it keeps
    the replicated bank and logs the JAX package's line."""
    for extra, error, match in (
            (["--shard_bank"], None, "--shard_bank: single device, keeping "
                                     "the replicated bank"),
            (["--erase_id", "std_typo"], ValueError, "unknown --erase_id"),
            (["--clip_weights_dir", str(tmp_path / "none")],
             FileNotFoundError, "none")):
        if error is None:
            assets = request.getfixturevalue("assets")
            csv = assets.root / "coco.csv"
            csv.write_text(COCO_CSV)
            save = tmp_path / "shard_bank"
            t_coco.main(_argv(assets, str(csv), save, *extra))
            assert match in _log(save / "logs.txt")
            assert len(os.listdir(save / "all")) == 3
            continue
        with pytest.raises(error, match=match):
            t_coco.main(["--data", "x.csv", "--save-dir",
                         str(tmp_path / "o"), "--device", "cpu", *extra])
    assert not (tmp_path / "o").exists()


# --------------------------------------------- against the JAX runners
class _Pending:
    def __init__(self, imgs):
        self.imgs = imgs

    def fetch(self):
        return self.imgs


class StubPipe:
    """Either package's pipeline surface: one seeded 32^2 image per row,
    every call's keywords recorded."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _img(seed):
        return np.random.RandomState(seed).randint(0, 256, (32, 32, 3),
                                                   dtype=np.uint8)

    def dispatch(self, prompt, **kw):
        self.calls.append(dict(kw, prompt=prompt))
        return _Pending([self._img(kw["seed"])])

    def dispatch_batch(self, prompts, seeds, guidance_scales, **kw):
        self.calls.append(dict(kw, prompts=list(prompts), seeds=list(seeds),
                               guidance_scales=list(guidance_scales)))
        return _Pending([self._img(s) for s in seeds])

    def enable_int8(self):
        return 0


def _comparable(lines):
    """Log lines from the dataset size on: wall times and CLIP numbers
    out (compared apart)."""
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("coco dataset size")
                 or line.startswith("Seed: "))
    out = []
    for line in lines[start:]:
        line = re.sub(r"[0-9.]+ seconds$", "S seconds", line)
        out.append(re.sub(r"(CLIP score.*: )\S+( over.*)?$", r"\1N\2", line))
    return out


def _calls_match(t_calls, j_calls, keys):
    assert len(t_calls) == len(j_calls)
    for t, j in zip(t_calls, j_calls):
        for k in keys:
            assert t[k] == j[k], (k, t[k], j[k])


def _same_tree(t_dir, j_dir):
    names = sorted(os.listdir(t_dir))
    assert names == sorted(os.listdir(j_dir))
    for n in names:
        with Image.open(os.path.join(j_dir, n)) as im:
            assert np.array_equal(read_png(os.path.join(t_dir, n)),
                                  np.asarray(im.convert("RGB"))), n


@pytest.mark.parametrize("mode", ["per_case", "batched", "hf_dataset"])
def test_coco_runner_matches_the_jax_runner(tmp_path, monkeypatch,
                                            tiny_towers, mode):  # noqa: F811
    """Both COCO runners on one stub pipeline and the same tiny CLIP
    directory: the same log lines in the same case order (CLIP scores
    within 1e-4), the same all/ images, the same pipeline arguments, and
    config.yaml with the same keys and values (but --device) in per-case
    mode only. hf_dataset: --hf_dataset_dir on a parquet file with the
    Recap-COCO-30K schema, per case."""
    csv = tmp_path / "coco.csv"
    csv.write_text(COCO_CSV)
    clip_dir, _, _ = tiny_clip_dir(tmp_path / "clip")
    extra = ["--data", str(csv), "--num_inference_steps", "2",
             "--image_length", "32", "--clip_weights_dir", clip_dir,
             "--valid_case_numbers", "0,100000"]
    if mode == "batched":
        extra += ["--batch_size", "2"]
    if mode == "hf_dataset":
        extra += ["--hf_dataset_dir", _recap_parquet(tmp_path)]
    pipes = {}
    for name, mod in (("jax", j_coco), ("port", t_coco)):
        pipes[name] = StubPipe()
        monkeypatch.setattr(mod, "build_pipeline",
                            lambda args, logger, p=pipes[name]: p)
        argv = ["--save-dir", str(tmp_path / name), *extra]
        mod.main(argv + (["--device", "cpu"] if name == "port" else []))
    t_dir, j_dir = tmp_path / "port", tmp_path / "jax"
    t_lines, j_lines = _log(t_dir / "logs.txt"), _log(j_dir / "logs.txt")
    assert _comparable(t_lines) == _comparable(j_lines)
    t_scores, j_scores = _clip_lines(t_lines), _clip_lines(j_lines)
    assert list(t_scores) == list(j_scores) and len(t_scores) >= 3
    for k, v in j_scores.items():
        assert abs(t_scores[k] - v) <= 1.5e-4, (k, t_scores[k], v)
    _same_tree(t_dir / "all", j_dir / "all")
    common = ["num_inference_steps", "negative_prompt",
              "negative_prompt_space", "height", "width"]
    if mode == "batched":
        common += ["prompts", "seeds", "guidance_scales"]
    else:
        common += ["prompt", "seed", "guidance_scale"]
    _calls_match(pipes["port"].calls, pipes["jax"].calls, common)
    for t, j in zip(pipes["port"].calls, pipes["jax"].calls):
        j_sf = {k: v for k, v in j["safree_dict"].items() if k != "logger"}
        assert t["safree_dict"] == j_sf
        assert t["erase_spec"].text_method == j["erase_spec"].text_method
        assert t["repellency_processor"] is j["repellency_processor"] is None
    if mode == "batched":
        assert not (t_dir / "config.yaml").exists()
        assert not (j_dir / "config.yaml").exists()
    else:
        t_cfg = yaml.safe_load((t_dir / "config.yaml").read_text())
        j_cfg = yaml.safe_load((j_dir / "config.yaml").read_text())
        assert {k: v for k, v in t_cfg.items() if k not in OWN} == \
            {k: v for k, v in j_cfg.items() if k not in OWN}


def test_sd3_coco_runner_output_tree(sd3_assets, monkeypatch):  # noqa: F811
    """main_coco30k on the tiny SD3 checkpoint with the SD3 kernel_fast
    task and SAFREE on (its default): all/<case>.png, the wall lines,
    the repellency in its window, and config.yaml from the flags alone
    (the reference merges no task config here)."""
    monkeypatch.setenv("SDT_RUNNER_DEPTH", "2")
    save = sd3_assets.root / "sd3_coco"
    t_sdv3.main_coco30k(["--data", sd3_assets.csv, "--save-dir", str(save),
                         "--model_dir", sd3_assets.ckpt,
                         "--num_inference_steps", "3", "--image_length",
                         "16", "--task_config", sd3_assets.task,
                         "--device", "cpu"])
    lines = _log(save / "logs.txt")
    assert "Repellency method : kernel_fast" in lines
    assert sum(line.startswith("Among") for line in lines) == 2   # SAFREE
    assert any("Repellency applied at timestep 1000.0" in line
               for line in lines)
    assert sum(line.startswith("Wall-Clock Time for image generation")
               for line in lines) == 2
    assert sorted(os.listdir(save / "all")) == ["0.png", "1.png"]
    assert read_png(str(save / "all" / "0.png")).shape == (16, 16, 3)
    cfg = yaml.safe_load((save / "config.yaml").read_text())
    assert "repellency" not in cfg and cfg["safree"] is True
    assert cfg["guidance_scale"] == 2.5
    assert not os.path.exists(save / "detect_dict.json")


def test_sd3_coco_runner_matches_the_jax_runner(tmp_path, monkeypatch):
    """Both SD3 COCO runners on one stub pipeline: the same log lines and
    case order, the same all/ images and pipeline arguments, and the same
    config.yaml (but --device); ``python -m ...runners.sdv3 coco30k``
    reaches main_coco30k."""
    csv = tmp_path / "coco.csv"
    csv.write_text(COCO_CSV)
    pipes = {}
    for name, mod in (("jax", j_sdv3), ("port", t_sdv3)):
        pipes[name] = StubPipe()
        stub = type("StubSD3", (), {"from_pretrained": staticmethod(
            lambda *a, p=pipes[name], **k: p)})
        monkeypatch.setattr(mod, "SafeDiffusion3Pipeline", stub)
        argv = ["--data", str(csv), "--save-dir", str(tmp_path / name),
                "--model_dir", "unused", "--num_inference_steps", "2",
                "--image_length", "32", "--int8"]
        mod.main_coco30k(argv + (["--device", "cpu"] if name == "port"
                                 else []))
    t_dir, j_dir = tmp_path / "port", tmp_path / "jax"
    assert _comparable(_log(t_dir / "logs.txt")) == \
        _comparable(_log(j_dir / "logs.txt"))
    _same_tree(t_dir / "all", j_dir / "all")
    _calls_match(pipes["port"].calls, pipes["jax"].calls,
                 ["prompt", "seed", "guidance_scale", "num_inference_steps",
                  "height", "width", "safree", "sf_alpha",
                  "repellency_processor"])
    t_cfg = yaml.safe_load((t_dir / "config.yaml").read_text())
    j_cfg = yaml.safe_load((j_dir / "config.yaml").read_text())
    assert {k: v for k, v in t_cfg.items() if k not in OWN} == \
        {k: v for k, v in j_cfg.items() if k not in OWN}

    from safe_denoiser_tpu_torch.pipeline import diffusion_sd3
    stub = StubPipe()
    monkeypatch.setattr(diffusion_sd3.SafeDiffusion3Pipeline,
                        "from_pretrained",
                        classmethod(lambda cls, *a, **k: stub))
    monkeypatch.setattr("sys.argv", [
        "sdv3", "coco30k", "--data", str(csv), "--save-dir",
        str(tmp_path / "main"), "--model_dir", "unused",
        "--num_inference_steps", "2", "--image_length", "32",
        "--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # module re-run
        runpy.run_module("safe_denoiser_tpu_torch.runners.sdv3",
                         run_name="__main__")
    assert [c["seed"] for c in stub.calls] == [11, 12, 13]
    assert sorted(os.listdir(tmp_path / "main" / "all")) == \
        ["0.png", "1.png", "2.png"]


# ------------------------------------------------------ Recap-COCO-30K
RECAP = {"image_id": [9, 4, None, 7, 2],
         "caption": ["a cat", "a dog", "a bird", None, "a fish"],
         "recaption": ["long a", "long b", "long c", "long d", "long e"],
         "image": [b"\x89PNG"] * 5}


def _recap_parquet(root, rows=RECAP):
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = root / "recap.parquet"
    pq.write_table(pa.table(rows), str(path))
    return str(path)


@pytest.mark.parametrize("layout", ["parquet_file", "parquet_dir",
                                    "save_to_disk"])
@pytest.mark.parametrize("gap", [True, False], ids=["id_gap", "ids"])
def test_hf_coco_dataset_matches_jax(tmp_path, layout, gap):
    """load_hf_coco_dataset from a parquet file, a directory of parquet
    shards or a save_to_disk directory (one split, not named train):
    the same cases as the JAX package's DataFrame through its iterator
    (the recaption branch: the caption, image_id as the case number, a
    NaN-shifted id column where an id is missing), and ``limit``."""
    import datasets
    rows = dict(RECAP)
    if not gap:
        rows["image_id"] = [9, 4, 3, 7, 2]
    if layout == "parquet_file":
        path = _recap_parquet(tmp_path, rows)
    elif layout == "parquet_dir":
        (tmp_path / "shards").mkdir()
        _recap_parquet(tmp_path / "shards", rows)
        path = str(tmp_path / "shards")
    else:
        path = str(tmp_path / "disk")
        datasets.DatasetDict({"validation": datasets.Dataset.from_dict(
            rows)}).save_to_disk(path)
    for limit in (10000, 3):
        want = j_load_hf(path, limit=limit)
        got = t_prompts.load_hf_coco_dataset(path, limit=limit)
        assert got.columns == list(want.columns)
        assert len(got) == len(want) == min(limit, 5)
        w_cases = list(j_iter_cases(want, default_guidance=7.5))
        g_cases = list(t_prompts.iter_prompt_cases(got, default_guidance=7.5))
        assert [repr((c.prompt, c.seed, c.guidance, c.row_index,
                      c.case_number)) for c in g_cases] == \
            [repr((c.prompt, c.seed, c.guidance, c.row_index,
                   c.case_number)) for c in w_cases]


def test_hf_coco_dataset_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="neither"):
        t_prompts.load_hf_coco_dataset(str(tmp_path))
    import datasets
    path = str(tmp_path / "two")
    ds = datasets.Dataset.from_dict({"caption": ["a"], "recaption": ["b"]})
    datasets.DatasetDict({"a": ds, "b": ds}).save_to_disk(path)
    with pytest.raises(ValueError, match="none is 'train'"):
        t_prompts.load_hf_coco_dataset(path)
