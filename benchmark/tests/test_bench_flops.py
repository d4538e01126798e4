"""Model FLOPs an image on the reference models at published widths (on
``meta``), equal to the port's own count (``utils/flops.py``) at these
configurations."""

import pytest

from benchmark.harness.flops import flops_per_image
from benchmark.tests import tiny


@pytest.mark.parametrize("family,config,mix,want", [
    ("sd1", "configs/sd14.json", "traffic/batch4-512-ddpm50.json",
     8.286846e13),
    ("sd3", "configs/sd3-medium.json", "traffic/batch1-1024-flow50.json",
     9.059215e14),
])
def test_flops_per_image(family, config, mix, want):
    got = flops_per_image(family, tiny._load(config), tiny._load(mix))
    assert float(f"{got['image']:.6e}") == want
