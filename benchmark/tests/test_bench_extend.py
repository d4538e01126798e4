"""A later change adds a configuration and a traffic mix as files of their
own plus entries in BENCHMARK.json: in a temporary copy of the benchmark,
the new cell runs (tiny, on the CPU) and no file that was there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness.spec import BENCH, ROOT
from benchmark.tests import tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_and_mix_are_files_and_entries(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = tiny.sd1_config()
    cfg["name"] = "sd1-tiny"
    (tmp_path / "benchmark/configs/sd1-tiny.json").write_text(
        json.dumps(cfg))
    mix = tiny.traffic("open-512-ddim10")
    (tmp_path / "benchmark/traffic/open-tiny.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/limits/sd1-tiny-open.json").write_text(
        json.dumps({"sample": 2,
                    "numbers": {"image_rel_rms": {"limit": 0.12}}}))
    manifest["configs"].append(
        {"name": "sd1-tiny", "source": cfg["source"],
         "file": "benchmark/configs/sd1-tiny.json", "reduced": [],
         "why": "tiny"})
    manifest["workloads"].append(
        {"name": "sd1-tiny-open", "config": "sd1-tiny",
         "traffic": "open-tiny", "chips": 1, "why": "tiny"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "sd14-serve-ddim10" in m.get("workloads", []):
            m["workloads"].append("sd1-tiny-open")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark.harness import runner, spec\n"
        "assert spec.BENCH.parent == __import__('pathlib').Path.cwd()\n"
        "cell = spec.load_cell('sd1-tiny-open')\n"
        "res = runner.run_cell(cell, 9, 0.6, True, device='cpu')\n"
        "print(json.dumps(res))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    assert {"queue_wait_ms.serve", "batch_fill.serve",
            "dispatch_block_ms.serve"} <= set(res["metrics"])
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
