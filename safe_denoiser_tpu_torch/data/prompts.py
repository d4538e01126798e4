"""Benchmark prompt CSVs with the reference's column-sniffing rules.

Counterpart of ``safe_denoiser_tpu/data/prompts.py`` over the stdlib
``csv`` module (the machine with the GPU has no pandas). The JAX package
reads a CSV with ``pandas.read_csv`` and sniffs each row of
``DataFrame.iterrows()``; its skip rules rest on pandas' types, which
``read_csv`` reproduces:

- a column whose cells all parse as integers is int; one empty (or
  NA-like) cell makes it float, with NaN there;
- a column of floats is float; a column of True/False is bool; any other
  column holds str, with NaN (a float) in its empty cells;
- an empty header cell is named ``Unnamed: <position>``;
- a row of ``iterrows`` holds Python values of one common type when every
  column is numeric (float when any column is), else each column's own.

So a float seed (a seed column with a gap) makes its row skip, as a NaN
prompt does. ``load_hf_coco_dataset`` gives the COCO runner's local
Recap-COCO-30K copy the same table form.
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from typing import Iterator, Optional

# pandas.read_csv's default NA strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False,
         "FALSE": False, "false": False}


@dataclass
class PromptCase:
    case_number: int | float | str
    prompt: str
    seed: int
    guidance: float
    categories: list[str]
    row_index: int


class PromptTable:
    """A CSV as pandas would type it: ``columns``, ``rows`` (dicts of
    Python values) and ``index`` (the row labels, kept through slicing)."""

    def __init__(self, columns: list[str], rows: list[dict],
                 index: list[int]):
        self.columns = columns
        self.rows = rows
        self.index = index

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, sl: slice) -> "PromptTable":
        """Positional row slicing, ``df[a:b]``."""
        return PromptTable(self.columns, self.rows[sl], self.index[sl])

    def drop(self, column: str) -> "PromptTable":
        cols = [c for c in self.columns if c != column]
        return PromptTable(cols, [{c: r[c] for c in cols} for r in self.rows],
                           self.index)

    def iterrows(self):
        """(label, row) pairs with ``DataFrame.iterrows``' value types."""
        kinds = {type(v) for r in self.rows for v in r.values()}
        common_float = kinds <= {int, float} and float in kinds
        for label, row in zip(self.index, self.rows):
            if common_float:
                row = {k: float(v) for k, v in row.items()}
            yield label, row


def _parse_int(s: str):
    t = s.strip()
    if t[:1] in "+-":
        body = t[1:]
    else:
        body = t
    return int(t) if body.isdigit() and body.isascii() else None


def _parse_float(s: str):
    t = s.strip()
    if "_" in t:
        return None
    try:
        return float(t)
    except ValueError:
        return None


def _type_column(cells: list[str]) -> list:
    na = [c in _NA for c in cells]
    vals = [c for c, n in zip(cells, na) if not n]
    if vals and all(_parse_int(c) is not None for c in vals):
        if not any(na):
            return [_parse_int(c) for c in cells]
        return [math.nan if n else float(_parse_int(c))
                for c, n in zip(cells, na)]
    if vals and all(_parse_float(c) is not None for c in vals):
        return [math.nan if n else _parse_float(c)
                for c, n in zip(cells, na)]
    if vals and not any(na) and all(c in _BOOL for c in vals):
        return [_BOOL[c] for c in cells]
    if not vals:
        return [math.nan] * len(cells)
    return [math.nan if n else c for c, n in zip(cells, na)]


def read_csv(path: str) -> PromptTable:
    """A prompt CSV typed as ``pandas.read_csv`` types it (see above)."""
    with open(path, newline="", encoding="utf-8") as f:
        records = list(csv.reader(f))
    header = records[0] if records else []
    columns = []
    for i, name in enumerate(header):
        name = name if name != "" else f"Unnamed: {i}"
        base, k = name, 1
        while name in columns:                  # pandas' dedup: a, a.1, ...
            name = f"{base}.{k}"
            k += 1
        columns.append(name)
    body = [r for r in records[1:] if r]        # pandas skips blank lines
    cells = [[(r[i] if i < len(r) else "") for r in body]
             for i in range(len(columns))]
    typed = [_type_column(c) for c in cells]
    rows = [{col: typed[j][i] for j, col in enumerate(columns)}
            for i in range(len(body))]
    return PromptTable(columns, rows, list(range(len(body))))


def load_hf_coco_dataset(path: str, limit: int = 10000) -> PromptTable:
    """The COCO runner's local Recap-COCO-30K copy (the JAX package's
    ``load_hf_coco_dataset``; the reference loads
    ``UCSC-VLAA/Recap-COCO-30K`` from the hub and selects its first 10000
    rows): ``path`` is a ``datasets.save_to_disk`` directory, a parquet
    file or a directory of parquet shards. Its first ``limit`` rows come
    back with the HF schema (``caption``/``recaption``/``image_id``;
    ``image`` dropped), so ``iter_prompt_cases``' recaption branch applies.
    Missing cells read as pandas' ``to_pandas`` gives them to the sniffing
    rules: an int column with a gap becomes float with NaN there, other
    gaps NaN. Needs the ``datasets`` package."""
    import glob
    import os

    try:
        import datasets
    except ImportError:
        raise ImportError("load_hf_coco_dataset needs the 'datasets' "
                          "package; without it, export the prompts to a "
                          "CSV and pass --data") from None

    if os.path.isdir(path) and (
            os.path.exists(os.path.join(path, "dataset_info.json"))
            or os.path.exists(os.path.join(path, "dataset_dict.json"))):
        ds = datasets.load_from_disk(path)
        if isinstance(ds, datasets.DatasetDict):
            if "train" in ds:
                ds = ds["train"]
            elif len(ds) == 1:
                ds = next(iter(ds.values()))
            else:
                raise ValueError(
                    f"{path} holds splits {sorted(ds.keys())} and none is "
                    "'train' — save the split you want with save_to_disk, "
                    "or point at its subdirectory")
    else:
        files = ([path] if path.endswith(".parquet")
                 else sorted(glob.glob(os.path.join(path, "*.parquet"))))
        if not files:
            raise FileNotFoundError(
                f"{path} is neither a datasets.save_to_disk dir nor a "
                "parquet file/dir")
        ds = datasets.load_dataset("parquet", data_files=files,
                                   split="train")
    ds = ds.select(range(min(limit, len(ds))))
    if "image" in ds.column_names:
        ds = ds.remove_columns(["image"])
    columns = list(ds.column_names)
    typed = []
    for col in columns:
        cells = ds[col]
        present = [v for v in cells if v is not None]
        if (len(present) < len(cells) and present
                and all(type(v) is int for v in present)):
            cells = [math.nan if v is None else float(v) for v in cells]
        typed.append([math.nan if v is None else v for v in cells])
    rows = [{col: typed[j][i] for j, col in enumerate(columns)}
            for i in range(len(ds))]
    return PromptTable(columns, rows, list(range(len(ds))))


def iter_prompt_cases(dataset: PromptTable,
                      default_guidance: Optional[float] = None,
                      valid_case_numbers: Optional[str] = None,
                      logger=None) -> Iterator[PromptCase]:
    """Yield benchmark cases with the reference's sniffing and fallback
    rules (the JAX package's ``iter_prompt_cases``)."""
    if valid_case_numbers:
        vstart, vend = valid_case_numbers.split(",")
        dataset = dataset[int(vstart):][:int(vend)]

    for _iter, data in dataset.iterrows():
        if "adv_prompt" in data:                       # MMA-Diffusion
            target_prompt, case_num = data["adv_prompt"], _iter
        elif "sensitive prompt" in data:               # Ring-A-Bell
            target_prompt, case_num = data["sensitive prompt"], _iter
        elif "prompt" in data:                         # I2P / COCO / nudity
            target_prompt = data["prompt"]
            case_num = data.get("case_number", _iter)
        elif "unsafe_prompt" in data:                  # CoPro
            target_prompt = data["unsafe_prompt"]
            case_num = data.get("idx", _iter)
        elif "recaption" in data:                      # Recap-COCO-30K rows
            target_prompt = data["caption"]
            case_num = data.get("image_id", _iter)
        else:
            continue

        if "guidance" in data:
            guidance = data["guidance"]
        elif default_guidance is not None:
            guidance = default_guidance
        else:
            guidance = 7.5

        if "evaluation_seed" in data:
            seed = data["evaluation_seed"]
        elif "sd_seed" in data:
            seed = data["sd_seed"]
        else:
            seed = 42

        if "categories" in data:
            categories = str(data["categories"]).split(", ")
        else:
            categories = ["nudity"]

        if logger is not None:
            logger.log(f"Seed: {seed}, Iter: {_iter}, Case#: {case_num}: "
                       f"target prompt: {target_prompt}")

        # broken-row skip (reference run_nudity.py:410-412)
        if (not isinstance(target_prompt, str) or not isinstance(seed, int)
                or not isinstance(guidance, (int, float))):
            continue
        yield PromptCase(case_number=case_num, prompt=target_prompt,
                         seed=int(seed), guidance=float(guidance),
                         categories=categories, row_index=int(_iter))


def shard_cases(cases: Iterator[PromptCase], num_shards: int,
                shard_id: int) -> Iterator[PromptCase]:
    """Fleet mode: round-robin partition of the cases over ``num_shards``
    processes; shard k takes the cases whose enumeration order % num_shards
    == k."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0 <= shard_id < num_shards:
        raise ValueError(
            f"shard_id {shard_id} out of range for num_shards {num_shards}")
    for i, case in enumerate(cases):
        if i % num_shards == shard_id:
            yield case
