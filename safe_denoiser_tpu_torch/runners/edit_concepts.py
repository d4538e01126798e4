"""Closed-form concept-editing CLI (UCE / RECE): produces the edited UNet
checkpoints the ``rece`` erase id swaps in.

Counterpart of ``safe_denoiser_tpu/runners/edit_concepts.py``, with its
flags and defaults plus ``--device``. No training loop: every
cross-attention K/V projection is solved in closed form from the concept,
target and preserve prompt encodings (``training/uce.py``), then exported
as a torch-layout state dict.

Usage:
    python -m safe_denoiser_tpu_torch.runners.edit_concepts \\
        --model_dir <ckpt> --erase "nudity" --method rece \\
        --preserve "a person" --save_path rece_nudity.safetensors
"""

from __future__ import annotations

import argparse
import os

import torch

from ..utils.config import read_json
from ..utils.logging import Logger
from .train_esd import export_unet


def _split(s: str | None) -> list[str]:
    return [p.strip() for p in s.split(",")] if s else []


def parse_args(argv=None) -> argparse.Namespace:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)
    cfg = read_json(pre_args.config) if pre_args.config else {}
    g = cfg.get

    p = argparse.ArgumentParser(
        description="Safe-Denoiser closed-form concept editor "
                    "(UCE / RECE, PyTorch/CUDA)", parents=[pre])
    p.add_argument("--model_dir", type=str, default=g("model_dir", None))
    p.add_argument("--erase", type=str, default=g("erase", "nudity"),
                   help="comma-separated concepts to erase")
    p.add_argument("--targets", type=str, default=g("targets", None),
                   help="comma-separated remap targets (default: the empty "
                        "prompt for every concept)")
    p.add_argument("--preserve", type=str, default=g("preserve", None),
                   help="comma-separated concepts whose K/V images must "
                        "not move")
    p.add_argument("--method", type=str, default=g("method", "uce"),
                   choices=["uce", "rece"])
    p.add_argument("--lamb", type=float, default=g("lamb", 0.5),
                   help="ridge anchor toward the original weights")
    p.add_argument("--erase_scale", type=float, default=g("erase_scale", 1.0))
    p.add_argument("--preserve_scale", type=float,
                   default=g("preserve_scale", 1.0))
    p.add_argument("--rece_iterations", type=int,
                   default=g("rece_iterations", 3))
    p.add_argument("--save_path", type=str,
                   default=g("save_path", "./edited_unet.safetensors"))
    p.add_argument("--save-dir", type=str, default=g("save_dir", None))
    p.add_argument("--device", type=str, default=g("device", "cuda"),
                   help="torch device to edit on (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    """Edit and export; returns the edited weights ({name: tensor})."""
    args = parse_args(argv)
    if args.model_dir is None:
        raise SystemExit("--model_dir pointing at a local HF-layout SD "
                         "checkpoint is required (no network egress).")

    from ..pipeline.diffusion import SafeDiffusionPipeline
    from ..training import edit_unet_concepts

    log_dir = args.save_dir or os.path.dirname(
        os.path.abspath(args.save_path))
    os.makedirs(log_dir, exist_ok=True)
    logger = Logger(os.path.join(log_dir, "edit_logs.txt"))
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")

    # f32 weights, as the JAX package's parameter tree
    pipe = SafeDiffusionPipeline.from_pretrained(
        args.model_dir, device=args.device, dtype=torch.float32,
        logger=logger)

    def encode_fn(prompt: str):
        return pipe.encode_prompt(prompt)[1][0]   # cond branch, [L, D]

    erase = _split(args.erase)
    targets = _split(args.targets) or None
    preserve = _split(args.preserve)
    logger.log(f"{args.method}: erase {erase} -> "
               f"{targets or ['<empty prompt>'] * len(erase)}, "
               f"preserve {preserve}")
    with torch.no_grad():
        edited = edit_unet_concepts(
            pipe.unet.state_dict(), encode_fn, erase, targets, preserve,
            method=args.method, lamb=args.lamb,
            erase_scale=args.erase_scale,
            preserve_scale=args.preserve_scale,
            rece_iterations=args.rece_iterations)

    export_unet(edited, args.save_path)
    logger.log(f"Edited UNet saved: {args.save_path}")
    print("end")
    return edited


if __name__ == "__main__":
    main()
