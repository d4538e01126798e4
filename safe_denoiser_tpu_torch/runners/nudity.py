"""Nudity benchmark runner: SD-v1.4 + erase_id pipeline + per-row CSV
prompts + NudeNet online gate + detect_dict.

Counterpart of ``safe_denoiser_tpu/runners/nudity.py``:

    python -m safe_denoiser_tpu_torch.runners.nudity --model_dir CKPT \\
        --task_config configs/nudity/safe_denoiser.yaml --data prompts.csv \\
        --erase_id std_rep --save-dir out/ [--device cpu]

writes ``logs.txt``, ``config.yaml``, ``detect_dict.json`` and each case's
PNG under ``all/`` and one of ``safe/`` or ``unsafe/`` (artist runs:
``all/<case>.png`` only). The loop overlaps cases (``common.run_cases``).
The negative prompt (space) the JAX runner derives serves SAFREE only,
which ``check_ported`` refuses, so every case here runs with the empty one.
"""

from __future__ import annotations

import os

from ..data import iter_prompt_cases, read_csv
from ..pipeline.diffusion import ERASE_SPECS
from ..utils.logging import Logger
from .common import (
    base_parser,
    build_eval,
    build_pipeline,
    build_repellency,
    check_ported,
    make_save_dirs,
    run_cases,
    shard_iter,
)


def main(argv=None):
    parser, _ = base_parser("Safe-Denoiser nudity benchmark (PyTorch port)",
                            argv)
    args = parser.parse_args(argv)
    check_ported(args)

    dirs = make_save_dirs(args.save_dir)
    logger = Logger(os.path.join(args.save_dir, "logs.txt"))
    logger.log("All configurations provided:")
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")

    dataset = read_csv(args.data)
    if "Unnamed: 0" in dataset.columns:
        dataset = dataset.drop("Unnamed: 0")
    logger.log(f"{args.category} dataset size: {len(dataset)}")

    erase_path = (args.erase_concept_checkpoint
                  if "std" not in args.erase_id else "na")
    logger.log(f"Erase_path: {erase_path}")
    pipe = build_pipeline(args, logger)
    repellency_processor, task_config = build_repellency(args, pipe, logger)
    erase_spec = ERASE_SPECS[args.erase_id]

    def dispatch(case):
        return pipe.dispatch(
            case.prompt,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=case.guidance,
            height=args.image_length, width=args.image_length,
            seed=case.seed,
            repellency_processor=repellency_processor,
            erase_spec=erase_spec)

    cases = shard_iter(args, iter_prompt_cases(
        dataset, default_guidance=args.guidance_scale,
        valid_case_numbers=args.valid_case_numbers, logger=logger))
    run_cases(args, cases, dispatch, build_eval(args), dirs, logger,
              task_config, skip_existing=args.resume)
    print("end")


if __name__ == "__main__":
    main()
