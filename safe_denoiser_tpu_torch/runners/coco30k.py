"""COCO-30k fidelity runner (BASELINE #2): vanilla (or safe) sampling over
the coco_30k prompt subset, an optional in-loop CLIPScore, each image
saved under ``all/`` for the offline FID/KID/CLIPScore.

Counterpart of ``safe_denoiser_tpu/runners/coco30k.py``
(``run_coco30k.py``):

    python -m safe_denoiser_tpu_torch.runners.coco30k --model_dir CKPT \\
        --data coco_30k_10k.csv --save-dir out/ \\
        [--clip_weights_dir CLIP_B32_DIR] [--task_config T.yaml \\
        --erase_id std_rep] [--batch_size 4] [--hf_dataset_dir DIR] \\
        [--device cpu]

writes ``logs.txt`` (the per-image ``CLIP score (Case#: ...)`` lines and
their mean), ``all/<case>.png`` and, case by case (``--batch_size 1``),
``config.yaml``. With ``--batch_size > 1`` the cases go through
``dispatch_batch`` in chunks, each row with its own seed and guidance; as
in the JAX package, that mode ignores ``--resume`` and writes no
``config.yaml``. ``SDT_RUNNER_DEPTH`` cases (or chunks) are in flight,
default 2; the outputs do not depend on it.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from ..data import iter_prompt_cases, read_csv, write_png
from ..device import ieee_f32, resolve_device
from ..models.clip_text import CLIPTextConfig, CLIPTextModel
from ..models.clip_vision import (CLIP_VISION_VIT_B_32, CLIPVisionModel,
                                  preprocess_clip)
from ..pipeline.diffusion import ERASE_SPECS
from ..utils.logging import Logger
from .common import (base_parser, build_pipeline, build_repellency,
                     dump_run_artifacts, make_save_dirs, shard_iter)
from .nudity import resolve_negative_space

# CLIP ViT-B/32's text tower (openai/clip-vit-base-patch32), quick_gelu as
# the JAX package builds it
CLIP_TEXT_VIT_B_32 = CLIPTextConfig(hidden_size=512, num_layers=12,
                                    num_heads=8, intermediate_size=2048,
                                    projection_dim=512)


class InLoopClipScore:
    """Per-image CLIPScore during the run (reference run_coco30k.py:
    177-234): CLIP ViT-B/32's text and vision towers from an HF model
    directory (``load_sharded_state_dict``; a missing projection head is
    the identity, as the JAX package converts it) with its ``tokenizer/``,
    both put on ``device`` (cuda unless asked) once, in f32 without TF32.
    The towers' configs are read from this module's constants when the
    scorer is built."""

    def __init__(self, weights_dir: str, device=None):
        from ..models.weights import (as_tensors, clip_text_state_dict,
                                      clip_vision_state_dict,
                                      load_sharded_state_dict)
        from ..text import CLIPTokenizer

        self.device = resolve_device(device)
        text_config, vision_config = CLIP_TEXT_VIT_B_32, CLIP_VISION_VIT_B_32
        sd = load_sharded_state_dict(weights_dir)
        text = CLIPTextModel(text_config, with_projection=True)
        text.load_state_dict(as_tensors(clip_text_state_dict(
            sd, text_config.projection_dim)))
        vision = CLIPVisionModel(vision_config)
        vision.load_state_dict(as_tensors(clip_vision_state_dict(
            sd, vision_config.projection_dim)))
        self.text_model = text.float().to(self.device).eval()
        self.vision_model = vision.float().to(self.device).eval()
        self.image_size = vision_config.image_size
        self.tokenizer = CLIPTokenizer.from_pretrained(
            os.path.join(weights_dir, "tokenizer"))

    @torch.no_grad()
    def __call__(self, image: np.ndarray, prompt: str) -> float:
        """CLIPScore of one uint8 image [H, W, 3] against ``prompt``."""
        from ..evals.clip_metrics import clip_score
        px = preprocess_clip(torch.as_tensor(np.array(image)[None],
                                             device=self.device),
                             size=self.image_size)
        ids = torch.as_tensor(self.tokenizer([prompt])["input_ids"],
                              device=self.device)
        with ieee_f32():
            img = self.vision_model(px)[2]
            txt = self.text_model(ids)[3]
            return float(clip_score(img, txt)[0])


def main(argv=None):
    parser, _ = base_parser("Safe-Denoiser COCO-30k fidelity run (PyTorch "
                            "port)", argv)
    parser.add_argument("--clip_weights_dir", type=str, default=None,
                        help="local CLIP ViT-B/32 weights for in-loop score")
    parser.add_argument("--hf_dataset_dir", type=str, default=None,
                        help="local Recap-COCO-30K copy: a datasets"
                             ".save_to_disk dir or parquet file/dir "
                             "(reference run_coco30k.py:284-285 pulls it "
                             "from the hub; zero egress here). Overrides "
                             "--data.")
    args = parser.parse_args(argv)
    if args.erase_id not in ERASE_SPECS:
        raise ValueError(f"unknown --erase_id {args.erase_id}: one of "
                         f"{sorted(ERASE_SPECS)}")
    # the scorer before anything is written: a bad weights dir fails first
    scorer = (InLoopClipScore(args.clip_weights_dir, device=args.device)
              if args.clip_weights_dir else None)

    dirs = make_save_dirs(args.save_dir)
    logger = Logger(os.path.join(args.save_dir, "logs.txt"))
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")

    if args.hf_dataset_dir:
        from ..data import load_hf_coco_dataset
        dataset = load_hf_coco_dataset(args.hf_dataset_dir)
    else:
        dataset = read_csv(args.data)
    logger.log(f"coco dataset size: {len(dataset)}")

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

    cases = list(shard_iter(args, iter_prompt_cases(
        dataset, default_guidance=args.guidance_scale,
        valid_case_numbers=args.valid_case_numbers, logger=logger)))

    # the next case's (or chunk's) generation is enqueued before the
    # previous one's images are fetched, saved and scored
    depth = max(1, int(os.environ.get("SDT_RUNNER_DEPTH", "2")))
    scores: list[float] = []
    inflight: deque = deque()

    def score(case, img):
        if scorer is not None:
            s = scorer(img, case.prompt)
            scores.append(s)
            logger.log(f"CLIP score (Case#: {case.case_number}): {s:.4f}")

    def log_mean():
        if scores:
            logger.log(f"mean CLIP score: {sum(scores) / len(scores):.4f} "
                       f"over {len(scores)} images")

    gen_kw = dict(num_inference_steps=args.num_inference_steps,
                  negative_prompt=negative_prompt,
                  negative_prompt_space=negative_prompt_space,
                  height=args.image_length, width=args.image_length,
                  repellency_processor=repellency_processor,
                  erase_spec=erase_spec, safree_dict=safree_dict)

    if args.batch_size > 1:
        # throughput mode: rows keep their own seeds and guidance, the CFG
        # pairs fold into one UNet batch (the reference is batch 1)
        def drain_chunk():
            chunk, pending, t0 = inflight.popleft()
            imgs = pending.fetch()
            logger.log(f"Wall-Clock Time for batch of {len(chunk)}: "
                       f"{time.time() - t0:.2f} seconds")
            for case, img in zip(chunk, imgs):
                write_png(img, os.path.join(dirs["all"],
                                            f"{case.case_number}.png"))
                score(case, img)

        for i in range(0, len(cases), args.batch_size):
            chunk = cases[i:i + args.batch_size]
            start = time.time()
            pending = pipe.dispatch_batch(
                [c.prompt for c in chunk], seeds=[c.seed for c in chunk],
                guidance_scales=[c.guidance for c in chunk], **gen_kw)
            inflight.append((chunk, pending, start))
            while len(inflight) >= depth:
                drain_chunk()
        while inflight:
            drain_chunk()
        log_mean()
        print("end")
        return

    def drain_case():
        case, pending, t0 = inflight.popleft()
        imgs = pending.fetch()
        logger.log(f"Wall-Clock Time for image generation "
                   f"(Case#: {case.case_number}): "
                   f"{time.time() - t0:.2f} seconds")
        write_png(imgs[0], os.path.join(dirs["all"],
                                        f"{case.case_number}.png"))
        score(case, imgs[0])

    for case in cases:
        if args.resume and os.path.exists(
                os.path.join(dirs["all"], f"{case.case_number}.png")):
            logger.log(f"[resume] skipping Case#: {case.case_number}")
            continue
        start = time.time()
        pending = pipe.dispatch(case.prompt, seed=case.seed,
                                guidance_scale=case.guidance, **gen_kw)
        inflight.append((case, pending, start))
        while len(inflight) >= depth:
            drain_case()
    while inflight:
        drain_case()
    log_mean()
    # reference run_coco30k.py:542: the merged config, whatever the cases
    dump_run_artifacts(args, args.save_dir, task_config)
    print("end")


if __name__ == "__main__":
    main()
