"""The benchmark of ``safe_denoiser_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the GPU it is started on: builds the
port's pipeline at the configuration's widths with weights drawn from the
seed, warms up every shape the cell uses, serves the cell's traffic for
``--seconds``, and with ``--trace 1`` traces a further stretch of it and
reads the per-layer metrics. It then checks a sample of what the window
served against the plain reference (``benchmark/reference``) and prints,
as its last line, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checked``, each compared number beside its limit (also the last lines
of standard error).

Exits non-zero without a result when no GPU (or fewer than the cell asks
for) is visible, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "safe_denoiser_tpu")


def process_seconds() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its CUDA kernels into build/torch_kernels itself)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton" / "cache")
    os.environ["TRITON_HOME"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for name in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[name] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import runner, spec

    cell = spec.load_cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"needs {chips} CUDA device(s); {seen} visible",
              file=sys.stderr)
        return 2
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             device="cuda", started=process_seconds)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    runner.print_checked(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
