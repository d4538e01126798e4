"""Offline evaluators over a run's ``all/`` directory.

The port's counterpart of the two root scripts
``evaluate_coco30k_fid_clip.py`` and ``evaluate_copro_aes_clip.py``, with
their flags and defaults, plus ``--device`` (cuda unless asked):

    python -m safe_denoiser_tpu_torch.runners.evaluate coco30k_fid_clip \\
        --sample_dir RUN/all --dataset_root COCO_IMGS \\
        --inception_weights pt_inception-2015-12-05.pth \\
        [--clip_weights_dir CLIP_B32_DIR --prompts_csv coco_30k_10k.csv]
    python -m safe_denoiser_tpu_torch.runners.evaluate copro_aes_clip \\
        --sample_dir RUN/all --clip_vision_weights VIT_L_14.safetensors \\
        --aes_weights sac+logos+ava1-l14-linearMSE.pth \\
        [--clip_weights_dir CLIP_B32_DIR --prompts_csv CoPro.csv]

Each prints its result dicts and writes the ``metrics_*.yaml`` files
beside ``--sample_dir`` (``evals/offline.py``).
"""

from __future__ import annotations

import argparse
import sys


def coco30k_fid_clip(argv=None) -> None:
    """FID/KID (+ CLIPScore with ``--clip_weights_dir``)."""
    from ..evals.offline import evaluate_clip_score, evaluate_fid

    p = argparse.ArgumentParser(
        description="Offline COCO-30k FID/KID + CLIPScore (PyTorch port)")
    p.add_argument("--sample_dir", required=True, help="<run>/all directory")
    p.add_argument("--dataset_root", default="datasets/coco30k_10k_img")
    p.add_argument("--prompts_csv", default="datasets/coco_30k_10k.csv")
    p.add_argument("--inception_weights", default=None,
                   help="pt_inception-2015-12-05 state dict (.pt/.safetensors)")
    p.add_argument("--clip_weights_dir", default=None,
                   help="local clip-vit-base-patch32 weights dir")
    p.add_argument("--allow_random_init", action="store_true",
                   help="plumbing smoke-runs only: random-init inception "
                        "(FID/KID numbers are NOT valid)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the towers (cuda, or cpu)")
    args = p.parse_args(argv)

    print(evaluate_fid(args.sample_dir, args.dataset_root,
                       args.inception_weights,
                       allow_random_init=args.allow_random_init,
                       device=args.device))
    if args.clip_weights_dir:
        print(evaluate_clip_score(args.sample_dir, args.prompts_csv,
                                  args.clip_weights_dir, device=args.device))


def copro_aes_clip(argv=None) -> None:
    """AES with ``--clip_vision_weights`` (+ CLIPScore with
    ``--clip_weights_dir``)."""
    from ..evals.offline import evaluate_aes_score, evaluate_clip_score

    p = argparse.ArgumentParser(
        description="Offline CoPro AES + CLIPScore (PyTorch port)")
    p.add_argument("--sample_dir", required=True, help="<run>/all directory")
    p.add_argument("--prompts_csv", default="datasets/CoPro_balanced_10k.csv")
    p.add_argument("--aes_weights",
                   default="pretrained/sac+logos+ava1-l14-linearMSE.pth")
    p.add_argument("--clip_vision_weights", default=None,
                   help="CLIP ViT-L/14 vision state dict")
    p.add_argument("--clip_weights_dir", default=None,
                   help="local clip-vit-base-patch32 weights dir")
    p.add_argument("--device", default="cuda",
                   help="torch device of the towers (cuda, or cpu)")
    args = p.parse_args(argv)

    if args.clip_vision_weights:
        print(evaluate_aes_score(args.sample_dir, args.aes_weights,
                                 args.clip_vision_weights,
                                 device=args.device))
    if args.clip_weights_dir:
        print(evaluate_clip_score(args.sample_dir, args.prompts_csv,
                                  args.clip_weights_dir,
                                  id_column="idx",
                                  prompt_column="unsafe_prompt",
                                  device=args.device))


EVALUATORS = {"coco30k_fid_clip": coco30k_fid_clip,
              "copro_aes_clip": copro_aes_clip}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in EVALUATORS:
        raise SystemExit(f"usage: python -m safe_denoiser_tpu_torch.runners."
                         f"evaluate {{{','.join(EVALUATORS)}}} [flags]")
    EVALUATORS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
