"""The knee of an open-loop cell: the highest offered rate whose backlog
does not grow over the window, found once by a sweep on the chip and then
written into the cell's traffic file as its fixed rate.

    python3 benchmark/sweep.py --workload sd14-serve-ddim10 --seed 5 \\
        --seconds 30 --rates 2,3,4,5,6

One process, one set-up; each rate runs the cell's window and prints one
line: offered and served rate, p50 and p90 latency, failures, batch fill,
and the growth of latency over the window (the least-squares slope of
latency against due time, in seconds a second: near 0 where the backlog
holds, near 1 - served/offered where it grows).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import set_cache_dirs
    set_cache_dirs()
    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    system = cell.family().System(cell.config, cell.traffic, args.seed,
                                  "cuda")
    load = cell.load().Load(system, cell.traffic, args.seed)
    load.warm_up()
    for rate in (float(r) for r in args.rates.split(",")):
        load.traffic["rate"] = rate
        out = load.window(args.seconds)
        dues = np.array([due for _, _, due, _, _ in load.offered])
        slope = float(np.polyfit(dues - dues[0], out["latencies"], 1)[0])
        rows = load.window_dispatches
        fill = sum(r for _, _, r in rows) / (len(rows) * load.batch)
        print(f"sweep rate={rate} served_per_s={out['images_per_s']:.4f} "
              f"p50_s={out['latency_p50_s']:.4f} "
              f"p90_s={out['latency_p90_s']:.4f} failed={out['failed']} "
              f"of {out['attempted']} fill={fill:.3f} "
              f"latency_slope={slope:.4f}", flush=True)
    load.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
