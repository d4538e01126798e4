"""HTTP serving runner: a pipeline behind the dynamic batcher.

Counterpart of ``safe_denoiser_tpu/runners/serve.py``, run as ``python -m
safe_denoiser_tpu_torch.runners.serve``. Requests hit the stdlib HTTP
front-end (``serving/server.py``), group in the ``DynamicBatcher`` to a
FIXED batch size, and run through ``dispatch_batch`` (the batcher's
two-phase hook) or ``generate_batch``: the sampling loop and the decode
replay from CUDA graphs (``pipeline/graph.py``), with per-sample seeds and
guidance scales as graph inputs, so padded partial groups reuse the same
graphs. The warm-up batch before the server starts captures them.
Repellency, SAFREE and SLD come through the same --task_config /
--erase_id surface as the nudity runner; --sd3 serves the SD3 family.
--export_aot writes the configuration's deployment bundle
(``serving/aot.py``) and exits; --aot_bundle serves at a bundle's baked
statics and refuses a server configured otherwise.

The flags and defaults are the JAX package's, plus ``--device`` (``cuda``;
tests pass ``cpu``). ``--mesh`` raises ``NotImplementedError``
(``common.check_ported``): data-parallel serving is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..utils.config import read_json
from ..utils.logging import Logger
from .common import check_ported


def parse_args(argv=None) -> argparse.Namespace:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)
    cfg = read_json(pre_args.config) if pre_args.config else {}
    g = cfg.get

    p = argparse.ArgumentParser(
        description="Safe-Denoiser generation server (PyTorch port)",
        parents=[pre])
    p.add_argument("--model_dir", type=str, default=g("model_dir", None))
    p.add_argument("--host", type=str, default=g("host", "127.0.0.1"))
    p.add_argument("--port", type=int, default=g("port", 8000))
    p.add_argument("--batch_size", type=int, default=g("batch_size", 4),
                   help="graphed batch size; requests group up to this")
    p.add_argument("--max_delay_ms", type=float,
                   default=g("max_delay_ms", 50.0),
                   help="max wait for a group to fill before a padded "
                        "partial batch launches")
    p.add_argument("--num_inference_steps", type=int,
                   default=g("num_inference_steps", 50))
    p.add_argument("--image_length", type=int,
                   default=g("image_length", None),
                   help="square image size (default: 512, or 1024 with "
                        "--sd3 -- the SD3 family default)")
    p.add_argument("--guidance_scale", type=float,
                   default=g("guidance_scale", None),
                   help="default guidance for requests that omit it "
                        "(default: 7.5, or 2.5 with --sd3)")
    p.add_argument("--erase_id", type=str, default=g("erase_id", "std"))
    p.add_argument("--erase_concept_checkpoint", type=str,
                   default=g("erase_concept_checkpoint", None))
    p.add_argument("--task_config", type=str, default=g("task_config", None),
                   help="repellency task YAML (optional)")
    p.add_argument("--negative_prompt", type=str,
                   default=g("negative_prompt", None))
    p.add_argument("--negative_prompt_space", type=str,
                   default=g("negative_prompt_space", None),
                   help="comma-separated concept list for the SAFREE "
                        "projection (safree erase ids; default: the nudity "
                        "concept space the runners use)")
    p.add_argument("--safe_level", type=str,
                   default=g("safe_level", "STRONG"),
                   help="SLD config row for sld erase ids "
                        "(WEAK|MEDIUM|STRONG|MAX)")
    p.add_argument("--shard_bank", action="store_true",
                   default=g("shard_bank", False),
                   help="shard the bank over devices (not ported yet)")
    p.add_argument("--mesh", type=int, default=g("mesh", None),
                   help="shard each served batch over an N-device data "
                        "mesh (not ported yet)")
    p.add_argument("--save-dir", type=str, default=g("save_dir", "./serve"))
    p.add_argument("--export_aot", type=str, default=g("export_aot", None),
                   help="write this serving configuration's deployment "
                        "bundle (serving/aot.py) to PATH and exit -- no "
                        "server is started")
    p.add_argument("--aot_bundle", type=str, default=g("aot_bundle", None),
                   help="serve at a deployment bundle's baked statics, "
                        "weights from --model_dir; refuses a server "
                        "configured otherwise")
    p.add_argument("--sd3", action="store_true", default=g("sd3", False),
                   help="serve the SD3 (MMDiT flow-matching) family: "
                        "--model_dir is an HF-layout SD3 checkpoint; "
                        "erase ids std (vanilla) / std_rep (repellency) / "
                        "safree[_rep] map onto the SD3 pipeline")
    p.add_argument("--int8", action="store_true", default=g("int8", False),
                   help="W8A8 int8 for the wide transformer matmuls "
                        "(UNet level-2/mid on SD-v1, MMDiT blocks on SD3)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the pipeline runs on (cuda, or cpu "
                        "for the plain PyTorch path)")
    args = p.parse_args(argv)
    # per-family defaults: the SD3 checkpoints are trained for 1024^2 and
    # low guidance (runners/sdv3.py's sd3_parser uses the same values)
    if args.image_length is None:
        args.image_length = 1024 if args.sd3 else 512
    if args.guidance_scale is None:
        args.guidance_scale = 2.5 if args.sd3 else 7.5
    return args


def _negative_space(args, erase_spec):
    """SAFREE concept space: --negative_prompt_space, else the nudity
    default the runners resolve."""
    if erase_spec.text_method != "safree":
        return None
    if args.negative_prompt_space:
        return [s.strip() for s in args.negative_prompt_space.split(",")]
    from .common import NUDITY_NEGATIVE_PROMPT_SPACE
    return list(NUDITY_NEGATIVE_PROMPT_SPACE)


def _sld_safe_config(args, erase_spec):
    if erase_spec.text_method != "sld":
        return None
    from ..pipeline.diffusion import SLD_CONFIGS
    return SLD_CONFIGS[args.safe_level]


def build_generate_fn(args, pipe, repellency_processor, erase_spec, logger):
    """-> run_batch(list[GenRequest]) -> list[uint8 HxWx3] for the batcher,
    with ``run_batch.dispatch_batch`` as the two-phase hook."""
    sf = {"safree": erase_spec.text_method == "safree"}
    negative_prompt_space = _negative_space(args, erase_spec)
    safe_config = _sld_safe_config(args, erase_spec)

    def _kwargs(reqs):
        return dict(
            prompts=[r.prompt for r in reqs],
            seeds=[r.seed for r in reqs],
            guidance_scales=[r.guidance_scale for r in reqs],
            num_inference_steps=args.num_inference_steps,
            negative_prompt=args.negative_prompt,
            negative_prompt_space=negative_prompt_space,
            height=args.image_length, width=args.image_length,
            repellency_processor=repellency_processor,
            safree_dict=sf,
            safe_config=safe_config,
            erase_spec=erase_spec)

    def run_batch(reqs):
        return pipe.generate_batch(**_kwargs(reqs))

    # two-phase protocol for the batcher's pipelining (batch k+1's loop is
    # enqueued before batch k's fetch/PNG/base64 -- serving/batcher.py)
    run_batch.dispatch_batch = lambda reqs: pipe.dispatch_batch(
        **_kwargs(reqs))
    return run_batch


def _check_baked(bundle, checks) -> None:
    """Refuse a server configured otherwise than the bundle's statics."""
    for key, want in checks:
        if bundle.meta.get(key) != want:
            raise SystemExit(
                f"--aot_bundle baked {key}={bundle.meta.get(key)} at export "
                f"time but the server is configured for {want} -- the "
                "bundle would silently run the baked statics; re-export "
                "with this config or match the flags")


def _check_shape(bundle, args) -> None:
    for key, want in (("batch_size", args.batch_size),
                      ("num_inference_steps", args.num_inference_steps),
                      ("height", args.image_length)):
        if int(bundle.meta[key]) != int(want):
            raise SystemExit(
                f"--aot_bundle was exported with {key}="
                f"{bundle.meta[key]} but the server is configured for "
                f"{want} -- re-export or match the flags")


def build_aot_generate_fn(args, pipe, repellency_processor, erase_spec,
                          logger):
    """-> run_batch at a deployment bundle's baked statics (serving/
    aot.py) on the live checkpoint's modules. 'none'-text-method erase ids
    run ``AotBundle.generate``; safree/sld ids prepare their text on the
    live pipeline and run ``generate_prepared``."""
    import torch

    from ..serving.aot import load_bundle

    bundle = load_bundle(args.aot_bundle, device=pipe.device)
    if bundle.meta.get("family", "sd14") != "sd14":
        raise SystemExit(
            f"--aot_bundle is a {bundle.meta.get('family')!r} bundle but "
            "the server is configured for the SD-v1 family -- add --sd3 or "
            "point at an SD-v1 bundle")
    if bundle.meta.get("text_method", "none") != erase_spec.text_method:
        raise SystemExit(
            f"--aot_bundle was exported for text_method "
            f"{bundle.meta.get('text_method')!r} but --erase_id "
            f"{args.erase_id!r} needs {erase_spec.text_method!r} -- "
            "re-export with this erase id")
    if (erase_spec.text_method == "sld"
            and bundle.meta.get("safe_level") != args.safe_level):
        raise SystemExit(
            f"--aot_bundle baked SLD safe_level="
            f"{bundle.meta.get('safe_level')} but the server is configured "
            f"for {args.safe_level} -- the momentum-guidance constants are "
            "baked in; re-export or match --safe_level")
    _check_shape(bundle, args)
    if bool(bundle.meta.get("int8")) != bool(args.int8):
        raise SystemExit(
            f"--aot_bundle was exported with int8="
            f"{bool(bundle.meta.get('int8'))} but the server is configured "
            f"for int8={bool(args.int8)} -- the quantized layer set is "
            "baked in; re-export or match the --int8 flag")
    if bool(args.int8):
        # min_dim decides which linears carry int8 weights
        live_min_dim = (pipe._int8_min_dim if pipe._int8_min_dim is not None
                        else int(os.environ.get("SDT_INT8_MIN_DIM", 1280)))
        baked = bundle.meta.get("int8_min_dim")
        if baked is not None and int(baked) != int(live_min_dim):
            raise SystemExit(
                f"--aot_bundle was exported with int8_min_dim={baked} but "
                f"the server quantized with min_dim={live_min_dim} -- the "
                "quantized layer sets differ; re-export or set "
                "SDT_INT8_MIN_DIM to match")
    # the erase window and the repellency statics are baked: a bank of the
    # same shape with another sigma, scale or window would silently run
    # the export-time values
    refs = live_cfg = None
    if repellency_processor is not None and erase_spec.repellency:
        refs = repellency_processor.get_proj_ref()
        live_cfg = dataclasses.asdict(repellency_processor.config())
    _check_baked(bundle, (("erase_spec", dataclasses.asdict(erase_spec)),
                          ("repellency_cfg", live_cfg)))
    logger.log(f"AOT bundle: {args.aot_bundle} "
               f"(exported on torch {bundle.meta.get('torch_version')}, "
               f"platform {bundle.meta.get('platform')}, "
               f"text_method {bundle.meta.get('text_method', 'none')})")

    if erase_spec.text_method == "none":
        def run_batch(reqs):
            return bundle.generate(
                pipe, prompts=[r.prompt for r in reqs],
                seeds=[r.seed for r in reqs],
                guidance_scales=[r.guidance_scale for r in reqs],
                negative_prompt=args.negative_prompt, refs=refs)
        return run_batch

    # safree/sld: live host text prep (the _prepare_text of the live
    # generate_batch), the bundle's loop and decode
    sf = {"safree": erase_spec.text_method == "safree"}
    negative_prompt_space = _negative_space(args, erase_spec)
    safe_config = _sld_safe_config(args, erase_spec)

    def run_batch(reqs):
        with torch.no_grad():
            per = [pipe._prepare_text(
                r.prompt, args.negative_prompt, negative_prompt_space, sf,
                erase_spec, safe_config, args.num_inference_steps)
                for r in reqs]
        text_embeds = torch.cat([t for t, _, _, _ in per], dim=1)
        embeds_alt = torch.cat([a for _, a, _, _ in per], dim=1)
        use_alt = torch.stack([u for _, _, u, _ in per], dim=1)  # [S, B]
        return bundle.generate_prepared(
            pipe, text_embeds, embeds_alt, use_alt, [r.seed for r in reqs],
            [r.guidance_scale for r in reqs], refs=refs)

    return run_batch


def _build_sd3_pipe(args, erase_spec, logger):
    """SD3 pipeline and optional repellency processor (the live,
    --export_aot and --aot_bundle paths). Erase ids map as std ->
    vanilla, *_rep -> flow-renoise repellency (window from the spec),
    safree* -> the T5 SAFREE projection; the SD3 family has no SLD."""
    from ..pipeline.diffusion_sd3 import SafeDiffusion3Pipeline
    from .sdv3 import build_sd3_repellency

    if erase_spec.text_method == "sld":
        raise SystemExit(
            f"--sd3 has no SLD pipeline (the reference's SD3 family is "
            f"vanilla/safree/safe-denoiser) -- got --erase_id {args.erase_id!r}")
    if args.erase_concept_checkpoint:
        raise SystemExit(
            "--sd3 does not take --erase_concept_checkpoint: the SD3 family "
            "has no UNet-swap erase ids -- point --model_dir at an HF-layout "
            "checkpoint carrying the fine-tuned transformer instead of "
            "serving base weights under an erased id")
    if args.model_dir is None:
        raise SystemExit(
            "--model_dir with a local HF-layout SD3 checkpoint is required "
            "(no network for hub downloads)")
    pipe = SafeDiffusion3Pipeline.from_pretrained(
        args.model_dir, device=args.device, logger=logger)
    if args.int8:
        pipe.enable_int8()
        logger.log("int8: MMDiT block matmuls quantized (W8A8)")
    repellency_processor = None
    if erase_spec.repellency and args.task_config:
        repellency_processor, _ = build_sd3_repellency(args, pipe, logger)
    return pipe, repellency_processor


def build_sd3_generate_fn(args, erase_spec, logger):
    """-> run_batch over ``SafeDiffusion3Pipeline.generate_batch``, with
    its ``dispatch_batch`` as the two-phase hook."""
    pipe, repellency_processor = _build_sd3_pipe(args, erase_spec, logger)

    def _kwargs(reqs):
        return dict(
            prompts=[r.prompt for r in reqs],
            seeds=[r.seed for r in reqs],
            guidance_scales=[r.guidance_scale for r in reqs],
            num_inference_steps=args.num_inference_steps,
            negative_prompt=args.negative_prompt,
            negative_prompt2=args.negative_prompt_space,
            height=args.image_length, width=args.image_length,
            safree=erase_spec.text_method == "safree",
            repellency_processor=repellency_processor,
            window=erase_spec.window)

    def run_batch(reqs):
        return pipe.generate_batch(**_kwargs(reqs))

    run_batch.dispatch_batch = lambda reqs: pipe.dispatch_batch(
        **_kwargs(reqs))
    return run_batch


def _sd3_live_repellency_meta(repellency_processor):
    """The substituted repellency config and the bank the live
    generate_batch runs with -- what an SD3 bundle bakes."""
    if repellency_processor is None:
        return None, None
    cfg = dataclasses.replace(
        repellency_processor.config(),
        sigma=1.0, normalize_x=True, use_beta_gate=False)
    return cfg, repellency_processor.get_proj_ref()


def build_sd3_aot_generate_fn(args, erase_spec, logger):
    """-> run_batch at an SD3 bundle's baked statics; SAFREE erase ids run
    their masked-T5 text preparation live (``generate_prepared``)."""
    from ..serving.aot import load_bundle

    pipe, repellency_processor = _build_sd3_pipe(args, erase_spec, logger)
    bundle = load_bundle(args.aot_bundle, device=pipe.device)
    if bundle.meta.get("family") != "sd3":
        raise SystemExit(
            f"--aot_bundle is a {bundle.meta.get('family', 'sd14')!r} "
            "bundle but the server is configured for --sd3 -- re-export "
            "with --sd3 --export_aot")
    _check_shape(bundle, args)
    if bool(bundle.meta.get("int8")) != bool(args.int8):
        raise SystemExit(
            f"--aot_bundle was exported with int8="
            f"{bool(bundle.meta.get('int8'))} but the server is configured "
            f"for int8={bool(args.int8)} -- re-export or match --int8")
    live_cfg, refs = _sd3_live_repellency_meta(repellency_processor)
    _check_baked(bundle, (
        ("repellency_cfg",
         None if live_cfg is None else dataclasses.asdict(live_cfg)),
        ("window", dataclasses.asdict(erase_spec.window))))
    logger.log(f"SD3 AOT bundle: {args.aot_bundle} "
               f"(exported on torch {bundle.meta.get('torch_version')}, "
               f"platform {bundle.meta.get('platform')})")

    if erase_spec.text_method == "safree":
        def run_batch(reqs):
            embeds, pooled = pipe._prepare_batch_embeds(
                [r.prompt for r in reqs], args.negative_prompt,
                args.negative_prompt_space, safree=True)
            return bundle.generate_prepared(
                pipe, embeds, pooled, [r.seed for r in reqs],
                [r.guidance_scale for r in reqs], refs=refs)
        return run_batch

    def run_batch(reqs):
        return bundle.generate(
            pipe, prompts=[r.prompt for r in reqs],
            seeds=[r.seed for r in reqs],
            guidance_scales=[r.guidance_scale for r in reqs],
            negative_prompt=args.negative_prompt, refs=refs)

    return run_batch


def build_run_batch(args, logger):
    """The configured ``run_batch`` (SD-v1 or SD3; live or from a
    bundle), or None after writing the bundle of --export_aot."""
    from ..pipeline.diffusion import ERASE_SPECS
    from .common import build_pipeline, build_repellency

    erase_spec = ERASE_SPECS[args.erase_id]
    if erase_spec.repellency and not args.task_config:
        raise SystemExit(
            f"--erase_id {args.erase_id!r} includes repellency but no "
            "--task_config was given -- the server would silently generate "
            "WITHOUT repellency under an erased id; pass the repellency "
            "task YAML or use a non-_rep erase id")
    if args.sd3:
        if args.export_aot:
            from ..serving.aot import export_pipeline_sd3, save_bundle
            pipe, proc = _build_sd3_pipe(args, erase_spec, logger)
            # export_pipeline_sd3 applies the SD3 substitutions itself:
            # hand it the processor's own config
            bundle = export_pipeline_sd3(
                pipe, batch_size=args.batch_size,
                num_inference_steps=args.num_inference_steps,
                height=args.image_length, width=args.image_length,
                repellency_cfg=None if proc is None else proc.config(),
                refs=None if proc is None else proc.get_proj_ref(),
                window=erase_spec.window)
            save_bundle(bundle, args.export_aot)
            logger.log(f"SD3 AOT bundle exported to {args.export_aot}")
            return None
        if args.aot_bundle:
            return build_sd3_aot_generate_fn(args, erase_spec, logger)
        return build_sd3_generate_fn(args, erase_spec, logger)
    pipe = build_pipeline(args, logger)
    repellency_processor, _ = build_repellency(args, pipe, logger)

    if args.export_aot:
        from ..serving.aot import export_pipeline, save_bundle
        cfg = refs = None
        if repellency_processor is not None and erase_spec.repellency:
            cfg = repellency_processor.config()
            refs = repellency_processor.get_proj_ref()
        bundle = export_pipeline(
            pipe, batch_size=args.batch_size,
            num_inference_steps=args.num_inference_steps,
            height=args.image_length, width=args.image_length,
            erase_spec=erase_spec, repellency_cfg=cfg, refs=refs,
            safe_level=args.safe_level)
        save_bundle(bundle, args.export_aot)
        logger.log(f"AOT bundle exported to {args.export_aot}")
        return None
    if args.aot_bundle:
        return build_aot_generate_fn(args, pipe, repellency_processor,
                                     erase_spec, logger)
    return build_generate_fn(args, pipe, repellency_processor, erase_spec,
                             logger)


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)          # before --save-dir is made
    os.makedirs(args.save_dir, exist_ok=True)
    logger = Logger(os.path.join(args.save_dir, "serve_logs.txt"))
    for arg in vars(args):
        logger.log(f"{arg}: {getattr(args, arg)}")
    run_batch = build_run_batch(args, logger)
    if run_batch is not None:
        _serve_loop(args, run_batch, logger)


def start_server(args, run_batch, logger):
    """The batcher and the HTTP front-end around ``run_batch``, after one
    padded warm-up batch (which captures the CUDA graphs) and before any
    request: (batcher, server); the caller runs ``serve_forever``."""
    from ..serving import DynamicBatcher, GenRequest, make_server

    batcher = DynamicBatcher(
        run_batch, args.batch_size,
        max_delay_s=args.max_delay_ms / 1000.0,
        dispatch_batch=getattr(run_batch, "dispatch_batch", None))
    logger.log("warmup: capturing the sampling loop and the decode...")
    run_batch([GenRequest(prompt="warmup")] * args.batch_size)
    logger.log("warmup done")
    server = make_server(batcher, host=args.host, port=args.port,
                         logger=logger,
                         default_guidance=args.guidance_scale)
    return batcher, server


def _serve_loop(args, run_batch, logger):
    """Serve until interrupted (the SD-v1 live and bundle paths and the
    SD3 path)."""
    batcher, server = start_server(args, run_batch, logger)
    logger.log(f"serving on http://{args.host}:{server.server_address[1]} "
               f"(batch_size={args.batch_size})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
