"""Benchmark runners (CLI entry points): ``python -m
safe_denoiser_tpu_torch.runners.nudity``, ``.sdv3`` (``.sdv3 coco30k``),
``.artist {ann_graham,munch}``, ``.copro``, ``.coco30k``, the NudeNet
seed sweep ``.classify``, the offline
evaluators, ``.evaluate {coco30k_fid_clip,copro_aes_clip}``, and the HTTP
server, ``.serve`` (``--export_aot`` / ``--aot_bundle``: the deployment
bundle)."""
