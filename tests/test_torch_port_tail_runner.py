"""The port's seed-sweep classifier runner and run-log tools on a tiny
checkpoint (CPU), against the JAX package's CLI and parsers.

``runners.classify`` has no size flag (as JAX's): its pipeline's
``dispatch`` is wrapped to ask for 32^2 images, so the tiny checkpoint
runs in seconds. The counts, rates, parsed records, CSVs and merged
detect dicts are compared for equality."""

import dataclasses
import json
import os

import numpy as np
import pytest

from safe_denoiser_tpu.runners import classify as j_classify
from safe_denoiser_tpu.tools import logs as j_logs
from safe_denoiser_tpu_torch.data.images import read_png
from safe_denoiser_tpu_torch.runners import classify as t_classify
from safe_denoiser_tpu_torch.runners import nudity as t_nudity
from safe_denoiser_tpu_torch.tools import logs as t_logs
from tests.test_torch_port_runner import assets, one_torch_thread  # noqa: F401


def _small_dispatch(monkeypatch):
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline
    orig = SafeDiffusionPipeline.dispatch

    def dispatch(pipe, prompt, **kw):
        return orig(pipe, prompt, height=32, width=32, **kw)

    monkeypatch.setattr(SafeDiffusionPipeline, "dispatch", dispatch)


@pytest.mark.parametrize("threshold", ["0.0", "0.5", "1.0"])
def test_skip_generation_matches_the_jax_cli(assets, tmp_path, capsys,
                                             threshold):
    rs = np.random.RandomState(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    from safe_denoiser_tpu_torch.data.images import write_png
    for i in range(5):
        write_png(rs.randint(0, 255, (40, 40, 3), dtype=np.uint8),
                  str(img_dir / f"{i}.png"))
    argv = ["--model_dir", "unused", "--nudenet-path", assets.onnx,
            "--img_dir", str(img_dir), "--skip_generation", "--threshold",
            threshold]
    want = j_classify.main(argv)
    j_out = capsys.readouterr().out
    got = t_classify.main(argv)
    assert got == want
    assert capsys.readouterr().out == j_out


def test_classify_generates_serial_equal_to_overlapped(assets, tmp_path,
                                                       monkeypatch):
    """Two seeds on the tiny checkpoint: N PNGs, each the pipeline's own
    ``dispatch(seed).fetch()``, the serial order (SDT_RUNNER_DEPTH=1) equal
    to the overlapped one, and the count and rate JAX's CLI gives on the
    same directory."""
    from safe_denoiser_tpu_torch.pipeline import SafeDiffusionPipeline

    _small_dispatch(monkeypatch)
    dirs = {}
    for depth in ("1", "3"):
        monkeypatch.setenv("SDT_RUNNER_DEPTH", depth)
        d = tmp_path / f"imgs{depth}"
        got = t_classify.main([
            "--model_dir", assets.ckpt, "--nudenet-path", assets.onnx,
            "--img_dir", str(d), "--prompt", "a cat", "--num_seeds", "2",
            "--num_inference_steps", "2", "--device", "cpu",
            "--threshold", "0.0"])
        assert got == (2, 1.0)
        assert sorted(os.listdir(d)) == ["0.png", "1.png"]
        dirs[depth] = {f: read_png(str(d / f)) for f in os.listdir(d)}
    for f in dirs["1"]:
        np.testing.assert_array_equal(dirs["1"][f], dirs["3"][f])
    pipe = SafeDiffusionPipeline.from_pretrained(assets.ckpt, device="cpu")
    img = pipe.dispatch("a cat", seed=1, num_inference_steps=2,
                        guidance_scale=7.5).fetch()[0]
    np.testing.assert_array_equal(img, dirs["1"]["1.png"])
    assert img.shape == (32, 32, 3)
    assert t_classify.main([
        "--model_dir", "unused", "--nudenet-path", assets.onnx, "--img_dir",
        str(tmp_path / "imgs1"), "--skip_generation"]) == j_classify.main([
            "--model_dir", "unused", "--nudenet-path", assets.onnx,
            "--img_dir", str(tmp_path / "imgs1"), "--skip_generation"])


def test_runner_logs_parse_and_shards_merge_as_jax(assets, tmp_path):
    """The port's nudity runner on 5 cases, unsharded and as --num_shards 2:
    ``parse_log`` and the CSV of its logs.txt equal JAX's, and the merged
    shards' detect dicts equal JAX's merge and the unsharded run's sizes,
    ratios and flags."""
    base = ["--data", assets.csv, "--model_dir", assets.ckpt,
            "--num_inference_steps", "2", "--image_length", "32",
            "--device", "cpu", "--nudenet-path", assets.onnx]
    t_nudity.main(base + ["--save-dir", str(tmp_path / "full")])
    for k in range(2):
        t_nudity.main(base + ["--save-dir", str(tmp_path / f"s{k}"),
                              "--num_shards", "2", "--shard_id", str(k)])
    text = (tmp_path / "full" / "logs.txt").read_text()
    got = [dataclasses.asdict(r) for r in t_logs.parse_log(text)]
    assert got == [dataclasses.asdict(r) for r in j_logs.parse_log(text)]
    assert [r["case_number"] for r in got] == ["0", "1", "2", "3", "4"]
    log = str(tmp_path / "full" / "logs.txt")
    assert t_logs.parse_log_file_to_csv(log, str(tmp_path / "t.csv")) == 5
    j_logs.parse_log_file_to_csv(log, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()

    shards = [json.loads((tmp_path / f"s{k}" / "detect_dict.json")
                         .read_text()) for k in range(2)]
    merged = t_logs.merge_detect_dicts(shards)
    assert merged == j_logs.merge_detect_dicts(shards)
    full = json.loads((tmp_path / "full" / "detect_dict.json").read_text())
    assert merged["toxic_size"] == full["toxic_size"]
    assert merged["toxic_ratio"] == full["toxic_ratio"]
    assert sorted(merged["unsafe"]) == sorted(full["unsafe"])
    for cat, v in full["toxic_pred_ratio"].items():
        assert merged["toxic_pred_ratio"][cat] == pytest.approx(v, rel=1e-12)
