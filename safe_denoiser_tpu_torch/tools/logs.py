"""Run-log parsing → per-case score CSV (reference mics/parse_score.py),
and the merge of the fleet shards' ``detect_dict.json``.

Counterpart of ``safe_denoiser_tpu/tools/logs.py`` (framework-free, copied):
``python -m safe_denoiser_tpu_torch.tools.logs parse logs.txt scores.csv``
and ``python -m safe_denoiser_tpu_torch.tools.logs merge out.json
shard*/detect_dict.json``.

The load-bearing log lines (SURVEY.md §5) are:
  "Seed: S, Iter: I, Case#: C: target prompt: P"
  "Optimized image is unsafe: B, toxicity pred: F"
  "Wall-Clock Time for image generation (Case#: C): T seconds"
  "---------- Repellency applied at timestep T ----------"
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class CaseRecord:
    case_number: str = ""
    seed: int | None = None
    prompt: str = ""
    unsafe: bool | None = None
    pred: float | None = None
    wall_clock_s: float | None = None
    repellency_timesteps: list[float] = field(default_factory=list)


_CASE = re.compile(r"Seed: (\d+), Iter: \S+, Case#: (\S+): target prompt: (.*)")
_PRED = re.compile(r"Optimized image is unsafe: (\w+), toxicity pred: ([\d.eE+-]+)")
_TIME = re.compile(r"Wall-Clock Time for image generation \(Case#: (\S+)\): ([\d.]+) seconds")
_REP = re.compile(r"Repellency applied at timestep ([\d.]+)")


def parse_log(text: str) -> list[CaseRecord]:
    records: list[CaseRecord] = []
    current: CaseRecord | None = None
    for line in text.splitlines():
        m = _CASE.search(line)
        if m:
            current = CaseRecord(case_number=m.group(2), seed=int(m.group(1)),
                                 prompt=m.group(3))
            records.append(current)
            continue
        if current is None:
            continue
        m = _REP.search(line)
        if m:
            current.repellency_timesteps.append(float(m.group(1)))
            continue
        m = _PRED.search(line)
        if m:
            current.unsafe = m.group(1) == "True"
            current.pred = float(m.group(2))
            continue
        m = _TIME.search(line)
        if m:
            current.wall_clock_s = float(m.group(2))
    return records


def parse_log_file_to_csv(log_path: str, csv_path: str) -> int:
    import csv

    records = parse_log(open(log_path).read())
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "seed", "prompt", "unsafe", "pred",
                    "wall_clock_s", "n_repellency_steps"])
        for r in records:
            w.writerow([r.case_number, r.seed, r.prompt, r.unsafe, r.pred,
                        r.wall_clock_s, len(r.repellency_timesteps)])
    return len(records)


def merge_detect_dicts(dicts: "list[dict]") -> dict:
    """Merge per-shard ``detect_dict.json`` payloads (fleet mode,
    --num_shards/--shard_id) into the dict a single-process run would have
    produced. Ratios are re-derived from counts: each shard's
    ``toxic_ratio[cat] * toxic_size[cat]`` recovers its unsafe count, so
    the merge is exact (no averaging-of-averages drift). The per-case
    ``unsafe`` lists concatenate in shard order — use the per-shard logs
    for case-level attribution.
    """
    unsafe: list = []
    counts: dict[str, int] = {}
    sizes: dict[str, int] = {}
    pred_sums: dict[str, float] = {}
    total_unsafe = 0
    total = 0
    for d in dicts:
        unsafe.extend(d.get("unsafe", []))
        ratio = d.get("toxic_ratio", {})
        pred = d.get("toxic_pred_ratio", {})
        size = d.get("toxic_size", {})
        for cat, n in size.items():
            if cat == "average":
                total += int(n)
                total_unsafe += round(ratio.get("average", 0.0) * n)
                continue
            sizes[cat] = sizes.get(cat, 0) + int(n)
            counts[cat] = counts.get(cat, 0) + round(ratio.get(cat, 0.0) * n)
            pred_sums[cat] = pred_sums.get(cat, 0.0) + pred.get(cat, 0.0) * n
    out: dict = {"unsafe": unsafe}
    out["toxic_ratio"] = {c: counts[c] / sizes[c] for c in sizes}
    out["toxic_pred_ratio"] = {c: pred_sums[c] / sizes[c] for c in sizes}
    out["toxic_size"] = dict(sizes)
    if total:
        out["toxic_ratio"]["average"] = total_unsafe / total
        out["toxic_size"]["average"] = total
    return out


def merge_detect_dict_files(out_path: str, shard_paths: "list[str]") -> dict:
    import json

    merged = merge_detect_dicts(
        [json.load(open(p)) for p in shard_paths])
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=2)
    return merged


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="log/result tooling (reference mics/parse_score.py)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("parse", help="logs.txt -> per-case CSV")
    pp.add_argument("log_path")
    pp.add_argument("csv_path")
    pm = sub.add_parser("merge", help="merge per-shard detect_dict.json "
                                      "files (fleet mode)")
    pm.add_argument("out_path")
    pm.add_argument("shards", nargs="+")
    args = p.parse_args(argv)
    if args.cmd == "parse":
        n = parse_log_file_to_csv(args.log_path, args.csv_path)
        print(f"{n} cases -> {args.csv_path}")
    else:
        merged = merge_detect_dict_files(args.out_path, args.shards)
        print(f"merged {len(args.shards)} shards -> {args.out_path} "
              f"(average toxic_ratio "
              f"{merged['toxic_ratio'].get('average', float('nan')):.4f})")


if __name__ == "__main__":
    _main()
