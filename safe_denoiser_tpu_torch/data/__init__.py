"""Data layer: negative-image banks and benchmark prompt CSVs."""

from .images import get_dataset, get_transform, read_png, write_png
from .prompts import (PromptCase, iter_prompt_cases, load_hf_coco_dataset,
                      read_csv, shard_cases)

__all__ = ["get_dataset", "get_transform", "read_png", "write_png",
           "PromptCase", "iter_prompt_cases", "load_hf_coco_dataset", "read_csv",
           "shard_cases"]
