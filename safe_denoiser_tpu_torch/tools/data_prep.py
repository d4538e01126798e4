"""Data-prep tooling (reference mics/process_data.py, mics/organize_data.py,
mics/sample_coco30k_10k.py, data/parse_CoPro*.py, data/word_count_i2p.py).

Counterpart of ``safe_denoiser_tpu/tools/data_prep.py``.
``generate_negative_bank`` closes the reference's data loop (SURVEY.md
§3.5): vanilla SD generates from I2P prompts, the online gate classifies,
unsafe outputs are filed into the negative-image bank that the repellency
processors later VAE-encode — the model's own unsafe outputs define the
repelled region.

The port runs without pandas and PIL, so the CSV helpers run
on the port's reader (``data.prompts.read_csv``, pandas' typing) and a
small writer with ``DataFrame.to_csv(index=False)``'s cells, and return a
``PromptTable`` where the JAX package returns a DataFrame:
``df.sample(n, random_state=seed)`` is
``np.random.RandomState(seed).choice(len, n, replace=False)`` in that row
order, ``Series.quantile`` numpy's linear quantile. Images are read and
written with the port's PNG codec; ``make_image_grid`` resizes with PIL's
default (bicubic) filter in numpy and returns the grid as a uint8 array.
Its ``blur_radius > 0`` needs PIL's GaussianBlur (``ImportError`` without
PIL).
"""

from __future__ import annotations

import csv
import importlib
import json
import math
import os
import shutil
from glob import glob

import numpy as np

from ..data.images import read_rgb, resize_bicubic, write_png
from ..data.prompts import PromptTable, read_csv


def generate_negative_bank(pipe, prompts, eval_func, out_dir: str,
                           threshold: float = 0.6,
                           num_inference_steps: int = 50,
                           guidance_scale: float = 7.5,
                           seed: int = 0, logger=None) -> int:
    """Vanilla-generate → gate → save unsafe images (mics/process_data.py)."""
    os.makedirs(out_dir, exist_ok=True)
    n_unsafe = 0
    for i, prompt in enumerate(prompts):
        imgs = pipe(prompt, num_inference_steps=num_inference_steps,
                    guidance_scale=guidance_scale, seed=seed + i)
        is_unsafe, pred = eval_func(imgs, threshold=threshold)
        if is_unsafe:
            write_png(imgs[0], os.path.join(out_dir, f"{i:06d}.png"))
            n_unsafe += 1
        if logger is not None:
            logger.log(f"[{i}] unsafe={is_unsafe} pred={pred:.3f}")
    return n_unsafe


def organize_by_category(src_dir: str, dst_root: str,
                         keywords: dict[str, list[str]]) -> dict[str, int]:
    """File results into per-category dirs by filename keyword
    (mics/organize_data.py)."""
    counts = {k: 0 for k in keywords}
    for path in sorted(glob(os.path.join(src_dir, "*.png"))):
        name = os.path.basename(path).lower()
        for category, words in keywords.items():
            if any(w in name for w in words):
                dst = os.path.join(dst_root, category)
                os.makedirs(dst, exist_ok=True)
                shutil.copy2(path, dst)
                counts[category] += 1
                break
    return counts


def _cell(v) -> str:
    """One value as ``DataFrame.to_csv`` writes it: NaN empty, a float by
    its repr, anything else by str."""
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_csv(table: PromptTable, path: str) -> None:
    """``DataFrame.to_csv(path, index=False)`` of a ``PromptTable``."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(table.columns)
        for row in table.rows:
            w.writerow([_cell(row[c]) for c in table.columns])


def _take(table: PromptTable, positions) -> PromptTable:
    return PromptTable(table.columns, [table.rows[p] for p in positions],
                       [table.index[p] for p in positions])


def sample_coco_subset(csv_in: str, csv_out: str, n: int = 10000,
                       seed: int = 42) -> PromptTable:
    """Random COCO-30k subset (mics/sample_coco30k_10k.py): pandas'
    ``df.sample(n, random_state=seed).reset_index(drop=True)``."""
    df = read_csv(csv_in)
    picks = np.random.RandomState(seed).choice(len(df), size=min(n, len(df)),
                                               replace=False)
    sub = _take(df, picks.tolist())
    sub.index = list(range(len(sub)))
    write_csv(sub, csv_out)
    return sub


def parse_copro_json(json_path: str, csv_out: str) -> PromptTable:
    """CoPro JSON → benchmark CSV (data/parse_CoPro.py schema:
    idx,unsafe_prompt,safe_prompt,concept,category)."""
    with open(json_path) as f:
        data = json.load(f)
    rows = []
    for i, item in enumerate(data if isinstance(data, list)
                             else data.values()):
        rows.append({
            "idx": item.get("idx", i),
            "unsafe_prompt": item.get("unsafe_prompt", item.get("prompt", "")),
            "safe_prompt": item.get("safe_prompt", ""),
            "concept": item.get("concept", ""),
            "category": item.get("category", ""),
        })
    columns = ["idx", "unsafe_prompt", "safe_prompt", "concept", "category"]
    table = PromptTable(columns if rows else [], rows, list(range(len(rows))))
    write_csv(table, csv_out)
    return table


def prompt_word_stats(csv_path: str, column: str = "prompt") -> dict:
    """Prompt length statistics (data/word_count_i2p.py /
    select_longest_prompts_i2p.py)."""
    df = read_csv(csv_path)
    lengths = np.array([len(str(r[column]).split()) for r in df.rows])
    return {"n": int(len(lengths)), "mean": float(lengths.mean()),
            "max": int(lengths.max()), "min": int(lengths.min()),
            "longest_idx": int(df.index[int(np.argmax(lengths))])}


def select_longest_prompts(csv_in: str, csv_out: str,
                           column: str = "prompt",
                           top_frac: float = 0.1) -> PromptTable:
    """Keep the rows whose prompt character-length is in the top
    ``top_frac`` quantile (data/select_longest_prompts_i2p.py: threshold =
    0.9-quantile of len(prompt), rows with length >= threshold kept)."""
    df = read_csv(csv_in)
    lengths = np.array([len(str(r[column])) for r in df.rows])
    threshold = np.quantile(lengths, 1.0 - top_frac)
    sub = _take(df, np.nonzero(lengths >= threshold)[0].tolist())
    write_csv(sub, csv_out)
    return sub


def _gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    try:
        pil = importlib.import_module("PIL.Image")
        pil_filter = importlib.import_module("PIL.ImageFilter")
    except ImportError:
        raise ImportError("make_image_grid(blur_radius > 0) blurs with PIL's "
                          "GaussianBlur, and PIL is not installed") from None
    return np.asarray(pil.fromarray(img).filter(
        pil_filter.GaussianBlur(radius)))


def make_image_grid(image_paths: list[str], out_path: str, cols: int = 4,
                    cell: int = 256, blur_radius: float = 0.0) -> np.ndarray:
    """Stack images into a grid PNG on white; optional blur
    (mics/grid_image.py / grid_blurred_image.py — used for redacted figure
    grids). Returns the grid, uint8 [rows·cell, cols·cell, 3]."""
    n = len(image_paths)
    rows = (n + cols - 1) // cols
    grid = np.full((rows * cell, cols * cell, 3), 255, np.uint8)
    for i, path in enumerate(image_paths):
        img = resize_bicubic(read_rgb(path), (cell, cell))
        if blur_radius > 0:
            img = _gaussian_blur(img, blur_radius)
        r, c = (i // cols) * cell, (i % cols) * cell
        grid[r:r + cell, c:c + cell] = img
    write_png(grid, out_path)
    return grid
