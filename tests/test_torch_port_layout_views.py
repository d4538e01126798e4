"""The Python side of B9's and B10's tensor maps (``csrc/attention_nt.cu``,
``csrc/attention_bshd.cu`` on ``csrc/attention_hopper.cuh``), on the CPU:
B1's predicate holds for the contiguous q/k/v the nt layout (as a
[BH, S, 1, D] view) and the bshd layout hand over, and fails for an odd
head dim or a base that is not 16-byte aligned; the wrapper's copies give
the same attention."""

import pytest
import torch

from safe_denoiser_tpu_torch.ops import attention

SHAPES = {"nt": (4, 64, 40), "bshd": (2, 512, 3, 40)}


def _tensors(layout, case):
    """Three bf16 q/k/v of the layout: contiguous at D = 40; at D = 20;
    or at D = 24 starting 4 or 8 elements (8 or 16 bytes) into a buffer."""
    shape = list(SHAPES[layout])
    if case == "odd_head_dim":
        shape[-1] = 20
    if case.startswith("offset"):
        shape[-1] = 24
        off = int(case[len("offset"):])
        n = torch.Size(shape).numel()
        return tuple(torch.zeros(n + off, dtype=torch.bfloat16)[off:]
                     .view(shape) for _ in range(3))
    return tuple(torch.zeros(shape, dtype=torch.bfloat16) for _ in range(3))


def _maps_view(layout, tensors):
    """What the wrapper hands the predicate: nt's [BH, S, D] as [BH, S, 1,
    D], bshd's [B, S, H, D] as it is."""
    return tuple(t[:, :, None] if layout == "nt" else t for t in tensors)


@pytest.mark.parametrize("layout", ["nt", "bshd"])
@pytest.mark.parametrize("case,want", [
    ("contiguous", True), ("offset8", True), ("odd_head_dim", False),
    ("offset4", False)])
def test_layout_tensor_map_predicate(layout, case, want):
    tensors = _tensors(layout, case)
    assert tensors[0].is_contiguous()
    assert attention.tensor_map_ready(*_maps_view(layout, tensors)) is want


@pytest.mark.parametrize("layout", ["nt", "bshd"])
@pytest.mark.parametrize("case", ["odd_head_dim", "offset4"])
def test_layout_staging_copies_keep_the_function(layout, case):
    """The copies (D zero-padded to a multiple of 8, a fresh aligned
    allocation) change no logit: the plain version on the staged tensors,
    cut back to D, equals it on the originals; one copy counted."""
    torch.manual_seed(0)
    q, k, v = _tensors(layout, case)
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape))
    d = q.shape[-1]
    before = attention.staging_copies
    staged = attention._staged(*_maps_view(layout, (q, k, v)))
    assert attention.staging_copies == before + 1
    assert attention.tensor_map_ready(*staged)
    assert all(t.is_contiguous() for t in staged)
    if layout == "nt":
        qs, ks, vs = (t[:, :, 0] for t in staged)
        want = attention.attention_nt_ref(q, k, v, d ** -0.5, 50)
        got = attention.attention_nt_ref(qs, ks, vs, d ** -0.5, 50)
    else:
        want = attention.attention_bshd_ref(q, k, v, d ** -0.5)
        got = attention.attention_bshd_ref(*staged, d ** -0.5)
    torch.testing.assert_close(got[..., :d], want, atol=0, rtol=0)
