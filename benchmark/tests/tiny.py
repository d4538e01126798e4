"""Tiny versions of the benchmark's cells for the CPU tests: the published
configuration files with every width cut down and the traffic mixes at a
few steps of 16^2 images, run through the same harness."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.harness import spec

BENCH = Path(__file__).resolve().parent.parent


def _load(rel: str) -> dict:
    with open(BENCH / rel) as f:
        return json.load(f)


def sd1_config(dtype: str | None = None) -> dict:
    cfg = _load("configs/sd14.json")
    c = cfg["components"]
    c["unet"].update(block_out_channels=[32, 64], layers_per_block=1,
                     cross_attention_dim=32, attention_head_dim=2,
                     norm_num_groups=8, sample_size=8)
    c["vae"].update(block_out_channels=[32, 64], layers_per_block=1,
                    norm_num_groups=8)
    c["text_encoder"].update(hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=2, intermediate_size=64,
                             vocab_size=600, projection_dim=32)
    return _with_dtype(cfg, dtype)


def sd3_config(dtype: str | None = None) -> dict:
    cfg = _load("configs/sd3-medium.json")
    c = cfg["components"]
    cfg["max_sequence_length"] = 16
    c["transformer"].update(num_layers=2, num_attention_heads=2,
                            attention_head_dim=16, joint_attention_dim=64,
                            caption_projection_dim=32,
                            pooled_projection_dim=64, sample_size=8,
                            pos_embed_max_size=16)
    for name in ("text_encoder", "text_encoder_2"):
        c[name].update(hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=64,
                       vocab_size=600, projection_dim=32)
    c["text_encoder_3"].update(d_model=64, d_kv=16, d_ff=128, num_layers=2,
                               num_heads=4, vocab_size=600)
    c["vae"].update(block_out_channels=[32, 64], layers_per_block=1,
                    norm_num_groups=8)
    return _with_dtype(cfg, dtype)


def _with_dtype(cfg: dict, dtype: str | None) -> dict:
    if dtype is not None:
        for comp in cfg["components"].values():
            comp["dtype"] = dtype
    return cfg


def traffic(name: str, **changes) -> dict:
    t = _load(f"traffic/{name}.json")
    t.update(height=16, width=16, trace_seconds=0.5, pool=64)
    t["repellency"].update(window=[1000.0, 300.0])
    if t["kind"] == "open":
        t.update(rate=8.0, grace_s=30.0, max_delay_ms=20.0, batch=2,
                 steps=4)
        t["repellency"].update(bank_rows=6, sigma=30.0, scale=0.4)
    elif name.startswith("batch4"):
        t.update(batch=2, steps=4)
        t["repellency"].update(bank_rows=6, sigma=30.0, scale=0.4)
    else:
        t.update(steps=6)
        t["repellency"].update(bank_rows=4, window=[1000.0, 500.0])
    t.update(changes)
    return t


def cell(config: dict, mix: dict, limit: float = 0.25, sample: int = 2,
         metric: str | None = None,
         numbers: tuple = ("image_rel_rms",)) -> spec.Cell:
    metric = metric or ("images_per_s" if mix["kind"] == "batch"
                        else "latency_p90_s")
    return spec.Cell(
        name="tiny", entry={"chips": 1}, config=copy.deepcopy(config),
        traffic=copy.deepcopy(mix),
        limits={"sample": sample,
                "numbers": {n: {"limit": limit} for n in numbers}},
        end_to_end=[{"name": metric, "unit": "x"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[])
