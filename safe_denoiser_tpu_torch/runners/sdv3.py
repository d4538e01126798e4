"""SD3 runners: the SD3 safe-denoiser pipeline (SAFREE on by default, the
renoising kernel_fast repellency) over per-row CSV prompts; the nudity
benchmark with the NudeNet gate and detect_dict, and the COCO-30k
fidelity run.

Counterpart of ``safe_denoiser_tpu/runners/sdv3.py``'s ``main_nudity``
and ``main_coco30k``:

    python -m safe_denoiser_tpu_torch.runners.sdv3 --model_dir SD3_CKPT \\
        --task_config configs/nudity/safe_denoiser.yaml --data prompts.csv \\
        --nudenet-path M.onnx --save-dir out/ [--int8] [--device cpu]
    python -m safe_denoiser_tpu_torch.runners.sdv3 coco30k \\
        --model_dir SD3_CKPT --data coco_30k_10k.csv --save-dir out/ \\
        [--task_config configs/coco/safe_denoiser_sdv3.yaml] [--int8]

with ``SDT_INT8_ATTN=1`` in the environment for the int8-QK^T attention.
Same flags and output trees as ``run_nudity_sdv3.py`` (``logs.txt``,
``config.yaml``, ``detect_dict.json``, ``all/`` + ``safe/`` | ``unsafe/``;
artist runs ``all/<case>.png`` only; the Q16 gate under ``--category
all``) and ``run_coco30k_sdv3.py`` (``logs.txt``, ``all/<case>.png``,
``config.yaml`` without the task config).
"""

from __future__ import annotations

import os
import sys
import time
from collections import deque

import numpy as np
import torch

from ..data import (get_dataset, get_transform, iter_prompt_cases, read_csv,
                    write_png)
from ..pipeline.diffusion_sd3 import SafeDiffusion3Pipeline
from ..pipeline.sampler import RepellencyWindow
from ..repellency import get_repellency_method
from ..utils.config import load_yaml
from ..utils.logging import Logger
from .common import (base_parser, build_eval, check_bank_matches_image_length,
                     dump_run_artifacts, make_save_dirs,
                     maybe_enable_bank_sharding, run_cases, shard_iter)


def build_sd3_repellency(args, pipe: SafeDiffusion3Pipeline, logger: Logger):
    """The task YAML's repellency processor with the SD3 VAE as the bank
    embedding (latent draw x scaling_factor, noise from a generator seeded
    0) and channel-normalized x. Without a scheduler, kernel_fast runs with
    its beta gate off. With ``cache_proj_ref`` the bank images are not
    read."""
    if args.task_config is None:
        return None, None
    task_config = load_yaml(args.task_config)
    data_config = task_config["data"]
    repellency_config = task_config["repellency"]
    if repellency_config["params"].get("cache_proj_ref"):
        ref_imgs = None
    else:
        dataset = get_dataset(**data_config,
                              transforms=get_transform(**data_config))
        ref_imgs = np.stack([dataset[i] for i in range(len(dataset))])
        check_bank_matches_image_length(ref_imgs, repellency_config,
                                        args.image_length)

    @torch.no_grad()
    def embed_fn(x):
        gen = torch.Generator(device=pipe.device).manual_seed(0)
        z = pipe.vae.sample_latent(torch.as_tensor(x, device=pipe.device),
                                   gen)
        return z * pipe.vae.config.scaling_factor

    processor = get_repellency_method(
        repellency_config["method"],
        ref_data=ref_imgs, embed_fn=embed_fn, forward_fn=None,
        num_timesteps=args.num_inference_steps, max_idx=None,
        beta_min=None, beta_max=None,
        n_embed=repellency_config["n_embed"],
        normalize_x=True, device=pipe.device,
        **repellency_config["params"])
    logger.log(f"Repellency method : {repellency_config['method']}")
    return processor, task_config


def sd3_parser(description: str, argv=None):
    parser, cfg = base_parser(description, argv)
    parser.set_defaults(guidance_scale=cfg.get("guidance_scale", 2.5),
                        image_length=cfg.get("image_length", 1024),
                        model_id=cfg.get(
                            "model_id",
                            "stabilityai/stable-diffusion-3-medium-diffusers"))
    parser.add_argument("--efficient", action="store_true",
                        default=cfg.get("efficient", False),
                        help="the reference's CPU-offload variant (warm-up "
                             "window end 880); no offload here")
    # the reference SD3 safe-denoiser pipeline applies SAFREE
    # unconditionally; --no_safree gives the vanilla pipeline's behaviour
    parser.set_defaults(safree=cfg.get("safree", True))
    parser.add_argument("--no_safree", dest="safree", action="store_false")
    # --int8 comes from base_parser (here: W8A8 on the MMDiT block linears)
    return parser


def main_nudity(argv=None):
    parser = sd3_parser("Safe-Denoiser SD3 nudity benchmark (PyTorch port)",
                        argv)
    args = parser.parse_args(argv)
    eval_func = build_eval(args)

    dirs = make_save_dirs(args.save_dir)
    logger = Logger(os.path.join(args.save_dir, "logs.txt"))
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")

    dataset = read_csv(args.data)
    if args.model_dir is None:
        raise SystemExit("--model_dir with a local SD3 checkpoint is required")
    pipe = SafeDiffusion3Pipeline.from_pretrained(
        args.model_dir, device=args.device, logger=logger)
    maybe_enable_bank_sharding(args, pipe, logger)
    if args.int8:
        pipe.enable_int8()
        logger.log("int8: MMDiT block matmuls quantized (W8A8)")
    repellency_processor, task_config = build_sd3_repellency(args, pipe,
                                                             logger)
    # the efficient variant's warm-up ends at 880
    window = RepellencyWindow(1000.0, 880.0 if args.efficient else 780.0)

    def dispatch(case):
        # negative_prompt None: the pipeline's 17-phrase string, as every
        # reference SD3 pipeline rebinds it
        return pipe.dispatch(
            case.prompt, seed=case.seed, guidance_scale=case.guidance,
            num_inference_steps=args.num_inference_steps,
            height=args.image_length, width=args.image_length,
            safree=args.safree, sf_alpha=args.sf_alpha,
            repellency_processor=repellency_processor, window=window)

    cases = shard_iter(args, iter_prompt_cases(
        dataset, default_guidance=args.guidance_scale,
        valid_case_numbers=args.valid_case_numbers, logger=logger))
    run_cases(args, cases, dispatch, eval_func, dirs, logger, task_config)
    print("end")


def main_coco30k(argv=None):
    """The COCO-30k fidelity run on SD3: each case's image under
    ``all/<case>.png`` (``SDT_RUNNER_DEPTH`` cases in flight, default 2),
    the repellency window [1000, 780] whatever ``--efficient`` says, and
    ``config.yaml`` from the flags alone (the reference dumps no task
    config here)."""
    parser = sd3_parser("Safe-Denoiser SD3 COCO-30k fidelity run (PyTorch "
                        "port)", argv)
    args = parser.parse_args(argv)

    dirs = make_save_dirs(args.save_dir)
    logger = Logger(os.path.join(args.save_dir, "logs.txt"))
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")

    dataset = read_csv(args.data)
    if args.model_dir is None:
        raise SystemExit("--model_dir with a local SD3 checkpoint is required")
    pipe = SafeDiffusion3Pipeline.from_pretrained(
        args.model_dir, device=args.device, logger=logger)
    maybe_enable_bank_sharding(args, pipe, logger)
    if args.int8:
        pipe.enable_int8()
        logger.log("int8: MMDiT block matmuls quantized (W8A8)")
    repellency_processor, _ = build_sd3_repellency(args, pipe, logger)

    depth = max(1, int(os.environ.get("SDT_RUNNER_DEPTH", "2")))
    inflight: deque = deque()

    def drain_one():
        case, pending, t0 = inflight.popleft()
        imgs = pending.fetch()
        logger.log(f"Wall-Clock Time for image generation "
                   f"(Case#: {case.case_number}): "
                   f"{time.time() - t0:.2f} seconds")
        write_png(imgs[0], os.path.join(dirs["all"],
                                        f"{case.case_number}.png"))

    for case in shard_iter(args, iter_prompt_cases(
            dataset, default_guidance=args.guidance_scale,
            valid_case_numbers=args.valid_case_numbers, logger=logger)):
        start = time.time()
        pending = pipe.dispatch(
            case.prompt, seed=case.seed, guidance_scale=case.guidance,
            num_inference_steps=args.num_inference_steps,
            height=args.image_length, width=args.image_length,
            safree=args.safree, sf_alpha=args.sf_alpha,
            repellency_processor=repellency_processor)
        inflight.append((case, pending, start))
        while len(inflight) >= depth:
            drain_one()
    while inflight:
        drain_one()
    # reference run_coco30k_sdv3.py:440: the flags' config, unconditionally
    dump_run_artifacts(args, args.save_dir, None)
    print("end")


if __name__ == "__main__":
    if sys.argv[1:2] == ["coco30k"]:
        main_coco30k(sys.argv[2:])
    else:
        main_nudity()
