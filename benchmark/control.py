"""Readings that set a cell's limits (``limits/<cell>.json``): the numbers
the comparison reads for sound runs of the program and for its control,
each on many seeds, in one process.

    python3 benchmark/control.py --workload sd14-batch --seconds 2 \\
        --program 101,102,... --int8 201,202,203 --ref fp8=301,302,303

``--program``: seeds of sound runs (the cell's own window, shortened).
``--int8``: the program with its own lower-precision path switched on
(``enable_int8`` W8A8 and ``SDT_INT8_ATTN=1``). ``--ref KIND=SEEDS``: the
reference computed with every weight and product input rounded (KIND
``fp8``: float8 e4m3, ``int8``: symmetric int8, both under a per-tensor
scale; ``bf16``: bfloat16) in the program's place, against the exact
reference; ``KIND=SEEDS@COMP+COMP`` rounds only those components.
``--numbers``: the numbers read (``harness/check.py``), by default the
cell's limits'. Each seed prints one line "reading <kind> seed=<n>
<number>=<value> ...". The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale (448 / max|x|)."""
    import torch
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def int8(x):
    """x rounded to symmetric int8 under a per-tensor scale."""
    scale = 127.0 / x.abs().amax().clamp(min=1e-30)
    return (x * scale).round().clamp(-127, 127) / scale


def bf16(x):
    import torch
    return x.to(torch.bfloat16).float()


ROUNDING = {"fp8": fp8, "int8": int8, "bf16": bf16}


def reference_control(cell, seed: int, device, quant) -> dict:
    """The check's numbers (the cell's limits') for the reference computed
    under ``quant`` in the program's place, on the requests a run of
    ``seed`` would sample (the first batches of its stream)."""
    import torch
    from benchmark.harness import check
    from benchmark.harness import traffic as gen
    from benchmark.harness.families.common import draw_bank
    from benchmark.harness.weights import draw_checkpoint
    from benchmark.reference import sample as ref
    from benchmark.reference.layers import ieee_f32

    pool = gen.requests(cell.traffic, seed)
    n, b = cell.limits["sample"], cell.traffic["batch"]
    picked = check.pick([check.Served(pool[i], None, None, i % b)
                         for i in range(max(n, b))], seed, n)
    needs = check.needs_of(cell.limits["numbers"])
    tensors = draw_checkpoint(cell.config, seed, device)
    bank = draw_bank(cell.config, cell.traffic, seed, device)
    fam, cfg, recipe = cell.config["family"], cell.config, cell.traffic
    got, refs, texts = [], [], []
    with torch.no_grad(), ieee_f32():
        for s in picked:
            r = s.request
            text = ref.text(fam, tensors, cfg, recipe, r.prompt, quant,
                            device)
            lat = ref.loop(fam, tensors, cfg, recipe, text, r.seed,
                           r.guidance, bank, quant, device)
            image = ref.decode(tensors, cfg, lat, quant)
            got.append(check.Served(r, image[0].cpu().numpy(),
                                    lat[0].cpu(), s.row))
            texts.append({k: v.cpu() for k, v in text.items()})
            refs.append(check.reference_outputs(
                fam, tensors, cfg, recipe, bank, r, got[-1].latents, needs,
                device))
    return check.numbers(got, refs, texts)


def with_int8(cell):
    """``cell`` with the program's own int8 path switched on after its
    pipeline is built."""
    base = cell.family()

    class System(base.System):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            os.environ["SDT_INT8_ATTN"] = "1"
            self.pipe.enable_int8()

    out = dataclasses.replace(cell)
    out.family = lambda: types.SimpleNamespace(System=System)
    return out


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", default="")
    p.add_argument("--int8", default="")
    p.add_argument("--ref", action="append", default=[])
    p.add_argument("--numbers", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import set_cache_dirs
    set_cache_dirs()
    from benchmark.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if args.numbers:
        cell = dataclasses.replace(cell, limits={
            "sample": cell.limits["sample"],
            "numbers": {n: {"limit": math.inf}
                        for n in args.numbers.split(",")}})
    runs = [("program", args.program, None), ("int8", args.int8, None)]
    for ref in args.ref:
        kind, _, rest = ref.partition("=")
        seeds, _, comps = rest.partition("@")
        quant = ROUNDING[kind]
        if comps:
            quant = {c: quant for c in comps.split("+")}
        runs.append((f"ref-{kind}" + (f"@{comps}" if comps else ""), seeds,
                     quant))
    for kind, seeds, quant in runs:
        for seed in _seeds(seeds):
            t0 = time.perf_counter()
            if quant is not None:
                found = reference_control(cell, seed, "cuda", quant)
            else:
                res = runner.run_cell(
                    cell if kind == "program" else with_int8(cell), seed,
                    args.seconds, False)
                found = res["candidates"]
                os.environ.pop("SDT_INT8_ATTN", None)
            print(f"reading {kind} seed={seed} "
                  + " ".join(f"{k}={v!r}" for k, v in found.items())
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
