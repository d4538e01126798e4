"""Image-grid helpers (reference main_utils.py:49-72 horz_stack/vert_stack).

Counterpart of ``safe_denoiser_tpu/utils/images.py`` (numpy only, copied).
"""

from __future__ import annotations

import numpy as np


def horz_stack(images) -> "np.ndarray":
    """Stack same-height images horizontally → one array [H, ΣW, 3]."""
    arrs = [np.asarray(img) for img in images]
    h = min(a.shape[0] for a in arrs)
    arrs = [a[:h] for a in arrs]
    return np.concatenate(arrs, axis=1)


def vert_stack(images) -> "np.ndarray":
    """Stack same-width images vertically → one array [ΣH, W, 3]."""
    arrs = [np.asarray(img) for img in images]
    w = min(a.shape[1] for a in arrs)
    arrs = [a[:, :w] for a in arrs]
    return np.concatenate(arrs, axis=0)
