"""Nudity benchmark runner: SD-v1.4 + erase_id pipeline + per-row CSV
prompts + NudeNet online gate + detect_dict.

Counterpart of ``safe_denoiser_tpu/runners/nudity.py``:

    python -m safe_denoiser_tpu_torch.runners.nudity --model_dir CKPT \\
        --task_config configs/nudity/safe_denoiser.yaml --data prompts.csv \\
        --erase_id std_rep --save-dir out/ [--device cpu]

writes ``logs.txt``, ``config.yaml``, ``detect_dict.json`` and each case's
PNG under ``all/`` and one of ``safe/`` or ``unsafe/`` (artist runs:
``all/<case>.png`` only). The loop overlaps cases: case i+1 is enqueued on
the GPU before case i's images are fetched, gated and written
(SDT_RUNNER_DEPTH cases in flight, default 2; SDT_EVAL_GROUP cases per
NudeNet pass, default 4); the outputs do not depend on either. The
negative prompt (space) the JAX runner derives serves SAFREE only, which
``check_ported`` refuses, so every case here runs with the empty one.
"""

from __future__ import annotations

import os
import time
from collections import deque

from ..data import iter_prompt_cases, read_csv, write_png
from ..pipeline.diffusion import ERASE_SPECS
from ..utils.logging import Logger
from .common import (
    DetectAggregator,
    base_parser,
    build_eval,
    build_pipeline,
    build_repellency,
    check_ported,
    dump_run_artifacts,
    make_save_dirs,
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
    eval_func = build_eval(args)
    artist = "artists-" in args.category

    agg = DetectAggregator()
    depth = max(1, int(os.environ.get("SDT_RUNNER_DEPTH", "2")))
    group = max(1, int(os.environ.get("SDT_EVAL_GROUP", "4")))
    inflight: deque = deque()
    ready: list = []

    def drain_one():
        case, pending, t0 = inflight.popleft()
        imgs = pending.fetch()
        logger.log(f"Wall-Clock Time for image generation "
                   f"(Case#: {case.case_number}): "
                   f"{time.time() - t0:.2f} seconds")
        if artist:
            write_png(imgs[0], os.path.join(dirs["all"],
                                            f"{case.case_number}.png"))
        else:
            ready.append((case, imgs))

    def flush_ready():
        if not ready:
            return
        results = eval_func.eval_many([imgs for _, imgs in ready],
                                      threshold=args.nudity_thr)
        for (case, imgs), (is_unsafe, pred) in zip(ready, results):
            agg.add(case.categories, is_unsafe, pred)
            tag = f"{case.case_number}_{'-'.join(case.categories)}.png"
            write_png(imgs[0], os.path.join(
                dirs["unsafe" if is_unsafe else "safe"], tag))
            write_png(imgs[0], os.path.join(dirs["all"], tag))
            logger.log(f"Optimized image is unsafe: {is_unsafe}, "
                       f"toxicity pred: {pred:.3f}")
        ready.clear()

    for case in shard_iter(args, iter_prompt_cases(
            dataset, default_guidance=args.guidance_scale,
            valid_case_numbers=args.valid_case_numbers, logger=logger)):
        if args.resume:
            tag = (f"{case.case_number}.png" if artist
                   else f"{case.case_number}_{'-'.join(case.categories)}.png")
            if os.path.exists(os.path.join(dirs["all"], tag)):
                logger.log(f"[resume] skipping Case#: {case.case_number}")
                continue
        start_time = time.time()
        pending = pipe.dispatch(
            case.prompt,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=case.guidance,
            height=args.image_length, width=args.image_length,
            seed=case.seed,
            repellency_processor=repellency_processor,
            erase_spec=erase_spec)
        inflight.append((case, pending, start_time))
        while len(inflight) >= depth:
            drain_one()
        if len(ready) >= group:
            flush_ready()
    while inflight:
        drain_one()
    flush_ready()

    if not artist:
        agg.dump(args, args.save_dir, logger, task_config)
    else:
        # the reference writes config.yaml and an empty detect_dict.json for
        # artist runs too (run_nudity.py:507,527-530)
        dump_run_artifacts(args, args.save_dir, task_config, detect_dict={})
    print("end")


if __name__ == "__main__":
    main()
