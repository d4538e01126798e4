"""Data layer: negative-image banks and benchmark prompt CSVs."""

from .images import (get_all_imgs, get_dataloader, get_dataset,
                     get_transform, load_image_bank, read_png, write_png)
from .prompts import (PromptCase, iter_prompt_cases, load_hf_coco_dataset,
                      load_prompt_csv, read_csv, shard_cases)

__all__ = ["get_dataset", "get_dataloader", "get_transform", "get_all_imgs",
           "load_image_bank", "read_png", "write_png", "PromptCase",
           "iter_prompt_cases", "load_hf_coco_dataset", "load_prompt_csv",
           "read_csv", "shard_cases"]
