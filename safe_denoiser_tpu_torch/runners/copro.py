"""CoPro benchmark runner: CoPro prompts, the Q16 online gate (category
``all``), repellency without the beta gate.

Counterpart of ``safe_denoiser_tpu/runners/copro.py`` (``run_copro.py``):

    python -m safe_denoiser_tpu_torch.runners.copro --model_dir CKPT \\
        --task_config configs/copro/safe_denoiser.yaml --data copro.csv \\
        --erase_id std_rep --clip_vision_weights VIT_L_14.safetensors \\
        --q16_path Q16_prompts.p --save-dir out/ [--device cpu]

writes ``logs.txt``, ``config.yaml``, ``detect_dict.json`` and each case's
``<case>.png`` under ``all/`` and one of ``safe/`` or ``unsafe/``. The
default ``--category nudity`` becomes ``all``: the Q16 gate, drained in
``Q16Eval.eval_many`` groups by the case loop (``common.run_cases``).
``--resume`` skips cases whose ``all/`` output exists; fleet shards split
the CSV.
"""

from __future__ import annotations

import os

from ..data import iter_prompt_cases, read_csv
from ..pipeline.diffusion import ERASE_SPECS
from ..utils.logging import Logger
from .common import (base_parser, build_eval, build_pipeline,
                     build_repellency, check_ported, make_save_dirs,
                     run_cases, shard_iter)
from .nudity import resolve_negative_space


def main(argv=None):
    parser, _ = base_parser("Safe-Denoiser CoPro benchmark (PyTorch port)",
                            argv)
    args = parser.parse_args(argv)
    check_ported(args)
    if args.category == "nudity":
        args.category = "all"     # CoPro's default is the Q16 gate
    if args.erase_id not in ERASE_SPECS:
        raise ValueError(f"unknown --erase_id {args.erase_id}: one of "
                         f"{sorted(ERASE_SPECS)}")
    eval_func = build_eval(args)

    dirs = make_save_dirs(args.save_dir)
    logger = Logger(os.path.join(args.save_dir, "logs.txt"))
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")

    dataset = read_csv(args.data)
    logger.log(f"CoPro dataset size: {len(dataset)}")

    pipe = build_pipeline(args, logger)
    repellency_processor, task_config = build_repellency(args, pipe, logger)
    erase_spec = ERASE_SPECS[args.erase_id]
    negative_prompt_space, negative_prompt = resolve_negative_space(args)
    safree_dict = {
        "re_attn_t": [int(t) for t in args.re_attn_t.split(",")],
        "alpha": args.sf_alpha, "safree": args.safree,
        "svf": args.self_validation_filter,
        "lra": args.latent_re_attention, "up_t": args.up_t,
        "category": args.category}

    def dispatch(case):
        return pipe.dispatch(
            case.prompt,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=case.guidance,
            negative_prompt=negative_prompt,
            negative_prompt_space=negative_prompt_space,
            height=args.image_length, width=args.image_length,
            seed=case.seed,
            repellency_processor=repellency_processor,
            erase_spec=erase_spec, use_beta_gate=False,
            safree_dict=safree_dict)

    cases = shard_iter(args, iter_prompt_cases(
        dataset, default_guidance=args.guidance_scale,
        valid_case_numbers=args.valid_case_numbers, logger=logger))
    run_cases(args, cases, dispatch, eval_func, dirs, logger, task_config,
              skip_existing=args.resume, number_tags=True)
    print("end")


if __name__ == "__main__":
    main()
