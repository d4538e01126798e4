"""The whole step's share (%) of the card's dense bf16 peak: model FLOPs
an image, counted on the reference models (``harness.flops``), times the
window's images_per_s, over 989 TFLOP/s."""

from benchmark.harness.device import PEAK_BF16_FLOPS


def read(run):
    rate = run.e2e.get("images_per_s")
    if not rate or not getattr(run.load, "records", None):
        return None
    image = run.system.flops_per_image()["image"]
    run.log(f"model FLOPs an image {image:.6e}, images_per_s {rate}")
    return 100.0 * image * rate / PEAK_BF16_FLOPS
