"""ESD concept-erasure trainer CLI: produces the fine-tuned UNet checkpoints
the ``esd`` erase id swaps in.

Counterpart of ``safe_denoiser_tpu/runners/train_esd.py``, with its flags
and defaults plus ``--device``. Flow: load an HF-layout SD checkpoint with
f32 master weights, encode the concept and the empty prompt once, keep a
frozen copy of the UNet in the compute dtype (bf16), then iterate the ESD
step (``training/esd.py``) on (x_t, t) points drawn near the concept's own
sampling trajectory (``sample_xt_for_esd``). On the card the student's
backward runs through B1b, B5b and B3b (``ops/``). The erased UNet is
exported as a torch-layout state dict (.safetensors or .pt), loadable by
``--erase_concept_checkpoint``; ``--lora_rank`` trains an adapter instead,
exported merged and, with ``--save_lora_path``, alone. Snapshots
(``--save_every``) are the port's own format (``training/checkpoint.py``).

Usage:
    python -m safe_denoiser_tpu_torch.runners.train_esd --model_dir <ckpt> \\
        --prompt "nudity" --train_method noxattn --iterations 1000 \\
        --save_path esd_nudity.safetensors
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..utils.config import read_json
from ..utils.logging import Logger

#: the compute dtype of the UNet's forwards (the JAX package's bf16 module)
COMPUTE_DTYPE = torch.bfloat16


def parse_args(argv=None) -> argparse.Namespace:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)
    cfg = read_json(pre_args.config) if pre_args.config else {}
    g = cfg.get

    p = argparse.ArgumentParser(
        description="Safe-Denoiser ESD erasure trainer (PyTorch/CUDA)",
        parents=[pre])
    p.add_argument("--model_dir", type=str, default=g("model_dir", None),
                   help="local HF-layout SD checkpoint dir (unet/ vae/ ...)")
    p.add_argument("--prompt", type=str, default=g("prompt", "nudity"),
                   help="concept to erase")
    p.add_argument("--train_method", type=str,
                   default=g("train_method", "noxattn"),
                   choices=["noxattn", "xattn", "selfattn", "full"],
                   help="parameter subset to fine-tune (ESD: noxattn for "
                        "global concepts like nudity, xattn for named "
                        "styles/objects)")
    p.add_argument("--iterations", type=int, default=g("iterations", 1000))
    p.add_argument("--lr", type=float, default=g("lr", 1e-5))
    p.add_argument("--negative_guidance", type=float,
                   default=g("negative_guidance", 1.0))
    p.add_argument("--start_guidance", type=float,
                   default=g("start_guidance", 3.0),
                   help="CFG scale for the partial denoise that draws x_t")
    p.add_argument("--denoise_steps", type=int, default=g("denoise_steps", 3),
                   help="coarse DDIM steps of the x_t draw")
    p.add_argument("--batch_size", type=int, default=g("batch_size", 1))
    p.add_argument("--image_length", type=int, default=g("image_length", 512))
    p.add_argument("--seed", type=int, default=g("seed", 42))
    p.add_argument("--log_every", type=int, default=g("log_every", 50))
    p.add_argument("--lora_rank", type=int, default=g("lora_rank", 0),
                   help="train a rank-r LoRA adapter instead of full "
                        "fine-tuning (0 = full fine-tune). Base weights "
                        "stay frozen; export is the merged UNet plus an "
                        "optional standalone adapter (--save_lora_path)")
    p.add_argument("--lora_alpha", type=float, default=g("lora_alpha", None),
                   help="LoRA merge alpha (default = rank, i.e. scale 1.0)")
    p.add_argument("--lora_targets", type=str,
                   default=g("lora_targets", None),
                   help="kernel subset for LoRA (default: derived from "
                        "--train_method; or xattn/selfattn/attn/full/"
                        "<path substring>)")
    p.add_argument("--save_lora_path", type=str,
                   default=g("save_lora_path", None),
                   help="also save the standalone adapter (.safetensors "
                        "or .pt), loadable via SafeDiffusionPipeline."
                        "load_lora")
    p.add_argument("--save_path", type=str,
                   default=g("save_path", "./esd_unet.safetensors"),
                   help=".safetensors or .pt: the torch-layout erased UNet")
    p.add_argument("--save-dir", type=str, default=g("save_dir", None),
                   help="log dir (defaults to the save_path directory)")
    p.add_argument("--save_every", type=int, default=g("save_every", 0),
                   help="snapshot (trained tensors, optimizer state, step, "
                        "generator) every N iterations (0 = off); atomic, "
                        "at <save_path>.train_state")
    p.add_argument("--resume", action="store_true",
                   default=g("resume", False),
                   help="continue from <save_path>.train_state if present "
                        "(bit-identical to an uninterrupted run)")
    p.add_argument("--device", type=str, default=g("device", "cuda"),
                   help="torch device to train on (cuda, or cpu for the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def export_unet(params, save_path: str) -> None:
    """The UNet's weights ({diffusers name: tensor}, the torch layout the
    JAX package's ``invert_unet`` writes) to ``save_path``: .safetensors,
    or a torch .pt for any other suffix."""
    from ..models.weights import save_safetensors
    sd = {k: v.detach().cpu().contiguous() for k, v in params.items()}
    if save_path.endswith(".safetensors"):
        save_safetensors(save_path, sd)
    else:
        torch.save(sd, save_path)


def main(argv=None):
    """Train and export; returns the exported weights ({name: tensor} on
    the device: the trained UNet, or under LoRA the merged one)."""
    args = parse_args(argv)
    if args.model_dir is None:
        raise SystemExit("--model_dir pointing at a local HF-layout SD "
                         "checkpoint is required (no network egress).")

    from ..pipeline.diffusion import SafeDiffusionPipeline
    from ..training import (ESDConfig, esd_param_mask, make_esd_train_step,
                            make_optimizer, sample_xt_for_esd)
    from ..training.esd import module_apply_fn

    log_dir = args.save_dir or os.path.dirname(
        os.path.abspath(args.save_path))
    os.makedirs(log_dir, exist_ok=True)
    logger = Logger(os.path.join(log_dir, "train_logs.txt"))
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")

    # f32 master weights: the module computes in COMPUTE_DTYPE through
    # module_apply_fn, as the JAX package's bf16 module with f32 params
    pipe = SafeDiffusionPipeline.from_pretrained(
        args.model_dir, device=args.device, dtype=torch.float32,
        logger=logger)
    dev = pipe.device
    if dev.type == "cuda":
        # bit-identical resume: cuDNN's conv backward picks deterministic
        # algorithms
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    b = args.batch_size
    embeds = pipe.encode_prompt(args.prompt)
    ctx_u = embeds[0].repeat(b, 1, 1)    # [B, L, D] empty-prompt states
    ctx_c = embeds[1].repeat(b, 1, 1)    # [B, L, D] concept states

    unet = pipe.unet
    params = dict(unet.named_parameters())
    cfg = ESDConfig(negative_guidance=args.negative_guidance,
                    learning_rate=args.lr)
    apply_fn = module_apply_fn(unet, COMPUTE_DTYPE)
    # the teacher never changes: one copy in the compute dtype (what the
    # cast inside apply_fn would give at every call)
    frozen = {n: p.detach().to(COMPUTE_DTYPE, copy=True)
              for n, p in params.items()}

    use_lora = args.lora_rank > 0
    if use_lora:
        from ..training import (apply_lora, init_lora_params, lora_scale,
                                make_lora_esd_train_step)
        for p in params.values():
            p.requires_grad_(False)
        targets = args.lora_targets or args.train_method
        lora = init_lora_params(
            params, torch.Generator(device=dev).manual_seed(args.seed + 1),
            args.lora_rank, targets, model_cfg=unet.config)
        scale = lora_scale(args.lora_rank, args.lora_alpha)
        n_train = sum(t.numel() for ab in lora.values() for t in ab.values())
        logger.log(f"lora rank={args.lora_rank} targets={targets}: "
                   f"{n_train:,} trainable parameters "
                   f"({len(lora)} kernels)")
        lora_step = make_lora_esd_train_step(apply_fn, cfg, scale=scale,
                                             model_cfg=unet.config)
        train_tree = lora
        opt = make_optimizer(cfg, lora)

        def step(x_t, t):
            return lora_step(lora, opt, params, x_t, t, ctx_c, ctx_u)[2]
    else:
        mask = esd_param_mask(params, args.train_method)
        n_train = sum(p.numel() for n, p in params.items() if mask[n])
        logger.log(f"train_method={args.train_method}: "
                   f"{n_train:,} trainable parameters")
        esd_step = make_esd_train_step(apply_fn, cfg)
        train_tree = params
        opt = make_optimizer(cfg, params, mask)

        def step(x_t, t):
            return esd_step(params, frozen, opt, x_t, t, ctx_c, ctx_u)[2]

    side = args.image_length // 8
    shape = (b, 4, side, side)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ckpt_path = args.save_path + ".train_state"
    start_it = 0
    if args.resume and os.path.exists(ckpt_path):
        from ..training import restore_train_state
        _, _, start_it, _, meta = restore_train_state(ckpt_path, train_tree,
                                                      opt, gen)
        ck_rank = int(meta.get("lora_rank", args.lora_rank))
        if ck_rank != args.lora_rank:
            raise SystemExit(
                f"--resume with --lora_rank {args.lora_rank} but "
                f"{ckpt_path} was written at lora_rank {ck_rank}")
        logger.log(f"resumed from {ckpt_path} at iter {start_it}")

    t0 = time.time()
    for it in range(start_it, args.iterations):
        x_t, t = sample_xt_for_esd(
            apply_fn, frozen, pipe.scheduler, ctx_c, ctx_u, gen, shape,
            num_steps=args.denoise_steps, guidance_scale=args.start_guidance)
        loss = step(x_t, t)
        if it % args.log_every == 0 or it == args.iterations - 1:
            logger.log(f"iter {it}: loss {float(loss):.6f} "
                       f"({time.time() - t0:.1f}s)")
        if args.save_every and (it + 1) % args.save_every == 0:
            # the generator's state after this iteration's draws: a resumed
            # run continues the same stream
            from ..training import save_train_state
            save_train_state(ckpt_path, train_tree, opt, it + 1, gen,
                             metadata={"prompt": args.prompt,
                                       "train_method": args.train_method,
                                       "lora_rank": args.lora_rank})

    if use_lora:
        with torch.no_grad():
            merged = apply_lora(params, lora, scale, model_cfg=unet.config)
        export_unet(merged, args.save_path)
        if args.save_lora_path:
            from ..training import save_lora
            save_lora(args.save_lora_path, lora, args.lora_rank,
                      args.lora_alpha, targets,
                      metadata={"prompt": args.prompt})
            logger.log(f"LoRA adapter saved: {args.save_lora_path}")
    else:
        export_unet(params, args.save_path)
    logger.log(f"Erased UNet saved: {args.save_path}")
    print("end")
    return merged if use_lora else params


if __name__ == "__main__":
    main()
