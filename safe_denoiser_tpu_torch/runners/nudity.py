"""Nudity benchmark runner: SD-v1.4 + erase_id pipeline + per-row CSV
prompts + NudeNet online gate + detect_dict.

Counterpart of ``safe_denoiser_tpu/runners/nudity.py``:

    python -m safe_denoiser_tpu_torch.runners.nudity --model_dir CKPT \\
        --task_config configs/nudity/safe_denoiser.yaml --data prompts.csv \\
        --erase_id std_rep --save-dir out/ [--device cpu]

writes ``logs.txt``, ``config.yaml``, ``detect_dict.json`` and each case's
PNG under ``all/`` and one of ``safe/`` or ``unsafe/`` (artist runs:
``all/<case>.png`` only). The gate is NudeNet for ``--category nudity``
and Q16 for ``all`` (with ``--clip_vision_weights``). The loop overlaps
cases (``common.run_cases``).
Every erase id of ``ERASE_SPECS`` runs, with SAFREE (``--safree``, its
self-validation filter ``-svf``), latent re-attention (``-lra``, with
``--safree`` also the SafeGuard filters from ``--freeu_hyp``) and SLD's
``--safe_level``, as in the JAX package's runner.
"""

from __future__ import annotations

import os

from ..data import iter_prompt_cases, read_csv
from ..models import FreeUConfig
from ..pipeline.diffusion import ERASE_SPECS, SLD_CONFIGS
from ..utils.logging import Logger
from .common import (
    NUDITY_NEGATIVE_PROMPT_SPACE,
    base_parser,
    build_eval,
    build_pipeline,
    build_repellency,
    check_ported,
    make_save_dirs,
    run_cases,
    shard_iter,
)


def resolve_negative_space(args) -> tuple[list[str], str | None]:
    """(negative prompt space, negative prompt) of the category and erase
    id: the nudity space for SAFREE ids, the artist's name for artist
    runs, else one blank; the joined space as the negative prompt for the
    safree_neg_prompt ids."""
    if args.category in ("nudity", "all"):
        space = (list(NUDITY_NEGATIVE_PROMPT_SPACE)
                 if "safree" in args.erase_id else [" "])
    elif "artists-" in args.category:
        name = args.category.split("-")[-1]
        space = [{"VanGogh": "Van Gogh",
                  "KellyMcKernan": "Kelly McKernan"}.get(name, name)]
    else:
        space = [" "]
    negative = (", ".join(space)
                if "safree_neg_prompt" in args.erase_id and len(space) > 1
                else None)
    return space, negative


def main(argv=None):
    parser, _ = base_parser("Safe-Denoiser nudity benchmark (PyTorch port)",
                            argv)
    args = parser.parse_args(argv)
    check_ported(args)
    if args.erase_id not in ERASE_SPECS:
        raise ValueError(f"unknown --erase_id {args.erase_id}: one of "
                         f"{sorted(ERASE_SPECS)}")
    eval_func = build_eval(args)

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

    freeu = None
    if args.safree and args.latent_re_attention:
        b1, b2, s1, s2 = (float(v) for v in args.freeu_hyp.split("-"))
        freeu = FreeUConfig(b1=b1, b2=b2, s1=s1, s2=s2, mode="all")
    safe_config = None
    if "sld" in args.erase_id:
        safe_config = SLD_CONFIGS[args.safe_level]
        logger.log(f"SLD safe level: {args.safe_level}")
        logger.log(f"SLD safe config: {safe_config}")
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
            erase_spec=erase_spec, safe_config=safe_config, freeu=freeu,
            safree_dict=safree_dict)

    cases = shard_iter(args, iter_prompt_cases(
        dataset, default_guidance=args.guidance_scale,
        valid_case_numbers=args.valid_case_numbers, logger=logger))
    run_cases(args, cases, dispatch, eval_func, dirs, logger, task_config,
              skip_existing=args.resume)
    print("end")


if __name__ == "__main__":
    main()
