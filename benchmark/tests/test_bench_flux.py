"""The FLUX.1-dev cell is files and entries added to the benchmark: its
entries come last in every list of BENCHMARK.json, and in a temporary copy
of the benchmark a tiny flux cell (every width cut down) runs through the
harness on the CPU, traced, with correct true, and changes no file that
was there."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness.spec import BENCH, ROOT, load_cell
from benchmark.tests import tiny

CELL, CONFIG, METRIC = "flux-dev-batch", "flux1-dev", "qk_rope_roofline"


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def tiny_config(dtype=None) -> dict:
    cfg = tiny._load(f"configs/{CONFIG}.json")
    c = cfg["components"]
    cfg["max_sequence_length"] = 16
    c["transformer"].update(num_layers=2, num_single_layers=2,
                            num_attention_heads=2, attention_head_dim=32,
                            joint_attention_dim=64, pooled_projection_dim=32,
                            axes_dims_rope=[4, 14, 14])
    c["text_encoder"].update(hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=2, intermediate_size=64,
                             vocab_size=600, projection_dim=32)
    c["text_encoder_2"].update(d_model=64, d_kv=16, d_ff=128, num_layers=2,
                               num_heads=4, vocab_size=600)
    c["vae"].update(block_out_channels=[32, 64], layers_per_block=1,
                    norm_num_groups=8)
    return tiny._with_dtype(cfg, dtype)


def test_the_cell_is_appended_last():
    """The configuration, the cell, the new metric and the cell's name in
    each metric's ``workloads`` are the last entries of their lists."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert manifest["configs"][-1]["name"] == CONFIG
    assert manifest["workloads"][-1]["name"] == CELL
    assert manifest["per_layer"][-1]["name"] == METRIC
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        names = m.get("workloads", [])
        assert CELL not in names[:-1], m["name"]
    cell = load_cell(CELL)
    assert {m["name"] for m in cell.per_layer} >= {
        METRIC, "attention_roofline", "mfu", "loop_ms"}
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s",
                                                    "setup_s"]


def test_tiny_flux_cell_runs_and_changes_no_file(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = tiny_config()
    cfg["name"] = "flux-tiny"
    (tmp_path / "benchmark/configs/flux-tiny.json").write_text(
        json.dumps(cfg))
    mix = tiny.traffic("batch1-1024-flux28", height=32, width=32)
    (tmp_path / "benchmark/traffic/flux-tiny.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/limits/flux-tiny-batch.json").write_text(
        json.dumps({"sample": 1, "numbers": {
            "image_rel_rms": {"limit": 0.12},
            "latent_rel_rms": {"limit": 0.12},
            "encode_rel_rms": {"limit": 0.12}}}))
    manifest["configs"].append(
        {"name": "flux-tiny", "source": cfg["source"],
         "file": "benchmark/configs/flux-tiny.json", "reduced": [],
         "why": "tiny"})
    manifest["workloads"].append(
        {"name": "flux-tiny-batch", "config": "flux-tiny",
         "traffic": "flux-tiny", "chips": 1, "why": "tiny"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("flux-tiny-batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark.harness import runner, spec\n"
        "assert spec.BENCH.parent == __import__('pathlib').Path.cwd()\n"
        "cell = spec.load_cell('flux-tiny-batch')\n"
        "res = runner.run_cell(cell, 2 ** 31 + 77, 0.6, True, "
        "device='cpu')\n"
        "print(json.dumps(res))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0, res["candidates"]
    # on the CPU nothing is traced: the trace's readers read nothing, the
    # launch counters count nothing, and no reader raises
    assert METRIC not in res["metrics"]
    assert "mfu" in res["metrics"] and "loop_ms" in res["metrics"]
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
