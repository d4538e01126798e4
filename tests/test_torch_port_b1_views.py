"""The Python side of B1's tensor maps (``csrc/attention.cu``), on the
CPU: the stride predicate holds for the main path's q/k/v views (no copy)
and fails for the views the wrapper copies first, and the copies give the
same attention."""

import pytest
import torch

from safe_denoiser_tpu_torch.ops import attention


def _views(layout, b=2, s=24, h=3, d=40):
    if layout == "projections":         # models/layers.py: three Linears
        return tuple(torch.zeros(b, s, h * d, dtype=torch.bfloat16)
                     .view(b, s, h, d) for _ in range(3))
    if layout == "joint_cat":           # models/mmdit.py: image + text rows
        return tuple(torch.cat([torch.zeros(b, s, h, d),
                                torch.zeros(b, 5, h, d)], 1).bfloat16()
                     for _ in range(3))
    if layout == "packed_qkv":
        return torch.zeros(b, s, 3, h, d, dtype=torch.bfloat16).unbind(2)
    if layout == "padded_rows":
        return tuple(torch.zeros(b, s, h, d + 4, dtype=torch.bfloat16)
                     [..., :d] for _ in range(3))
    if layout == "odd_head_dim":
        return tuple(torch.zeros(b, s, h, 36, dtype=torch.bfloat16)
                     for _ in range(3))
    raise ValueError(layout)


@pytest.mark.parametrize("layout,want", [
    ("projections", True), ("joint_cat", True), ("packed_qkv", True),
    ("padded_rows", False), ("odd_head_dim", False)])
def test_b1_tensor_map_predicate(layout, want):
    assert attention.tensor_map_ready(*_views(layout)) is want


def test_b1_tensor_map_predicate_at_sd3_head_dim():
    q, k, v = _views("joint_cat", b=1, s=8, h=24, d=64)
    assert attention.tensor_map_ready(q, k, v)


@pytest.mark.parametrize("layout", ["padded_rows", "odd_head_dim"])
def test_b1_staging_copies_keep_the_function(layout):
    """The wrapper's copies (D zero-padded to a multiple of 8) change no
    logit: the plain version on the staged tensors, cut back to D, equals
    it on the views; one copy counted per call."""
    torch.manual_seed(0)
    q, k, v = _views(layout)
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape))
    d = q.shape[3]
    before = attention.staging_copies
    qs, ks, vs = attention._staged(q, k, v)
    assert attention.staging_copies == before + 1
    assert attention.tensor_map_ready(qs, ks, vs)
    want = attention.attention_ref(q, k, v, d ** -0.5)
    got = attention.attention_ref(qs, ks, vs, d ** -0.5)[..., :d]
    torch.testing.assert_close(got, want, atol=0, rtol=0)

