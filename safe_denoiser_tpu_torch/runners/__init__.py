"""Benchmark runners (CLI entry points): ``python -m
safe_denoiser_tpu_torch.runners.nudity``, ``.sdv3`` (``.sdv3 coco30k``),
``.artist {ann_graham,munch}``, ``.copro``, ``.coco30k`` and the offline
evaluators, ``.evaluate {coco30k_fid_clip,copro_aes_clip}``."""
