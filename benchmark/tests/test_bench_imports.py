"""What the benchmark runs imports neither JAX nor the JAX package, and the
reference imports nothing of the program. Modules are compared by their
top-level name, whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys

from benchmark.harness.spec import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "safe_denoiser_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"safe_denoiser_tpu_torch",
                                         "benchmark"}), path


def test_a_run_loads_no_forbidden_module():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.run import forbidden_modules, set_cache_dirs\n"
        "set_cache_dirs()\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark.harness import runner, spec\n"
        "from benchmark.tests import tiny\n"
        "mix = tiny.traffic('open-512-ddim10')\n"
        "cell = tiny.cell(tiny.sd1_config(), mix)\n"
        "res = runner.run_cell(cell, 5, 0.5, False, device='cpu')\n"
        "for m in ('benchmark.harness.readers', 'benchmark.control'):\n"
        "    __import__(m)\n"
        "for w in json.load(open('BENCHMARK.json'))['per_layer']:\n"
        "    spec.load_cell('sd14-batch').reader(w)\n"
        "print(json.dumps({'bad': forbidden_modules(),\n"
        "                  'port': 'safe_denoiser_tpu_torch' in sys.modules,\n"
        "                  'correct': res['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "port": True, "correct": True}


def test_run_without_a_gpu_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sd14-batch", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "",
                              "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT / "build")})
    assert out.returncode != 0 and out.stdout.strip() == ""
