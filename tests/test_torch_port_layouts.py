"""The attention layouts of the port (``SDT_FLASH2_LAYOUT`` nt / bshd,
``SDT_ATTN_REPACK``) against the JAX package on the CPU.

Each layout kernel's plain version -- what a CPU tensor takes -- is held
against the TPU kernel run in interpret mode on the same numpy-seeded
inputs, and the port's ``self_attention`` against the JAX package's under
every combination of layout, ``SDT_INT8_ATTN`` and dtype. Tolerances: f32
round-off (2e-5, as the JAX package's kernel tests), ``attention.BF16_ATOL``
for bf16 (the bf16 probabilities and output); the head repacks are copies,
bit-exact. The CUDA kernels run on the GPU only (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.ops import attention as j_attn
from safe_denoiser_tpu_torch.ops import attention as t_attn

ENV = ("SDT_FLASH2_LAYOUT", "SDT_ATTN_REPACK", "SDT_INT8_ATTN")
LAYOUTS = {"bhsd": {}, "nt": {"SDT_FLASH2_LAYOUT": "nt"},
           "nt_repack": {"SDT_FLASH2_LAYOUT": "nt", "SDT_ATTN_REPACK": "1"},
           "bshd": {"SDT_FLASH2_LAYOUT": "bshd"}}


def _set_env(monkeypatch, layout: str, int8: bool) -> None:
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in LAYOUTS[layout].items():
        monkeypatch.setenv(name, value)
    if int8:
        monkeypatch.setenv("SDT_INT8_ATTN", "1")


def _inputs(shape, seed, dtype):
    """The same values for both packages: numpy f32 from a seed, rounded to
    bf16 once where dtype is bf16."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(*shape).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
                for a in arrs]
    jax_in = [jnp.asarray(a).astype(dtype) for a in arrs]
    torch_in = [torch.from_numpy(a.copy()).to(getattr(torch, dtype))
                for a in arrs]
    return jax_in, torch_in


def _close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=t_attn.BF16_ATOL, rtol=0)


# ------------------------------------------------------- the plain versions
@pytest.mark.parametrize("s,valid", [(512, None), (1024, 600), (512, 129),
                                     (1024, 1)],
                         ids=["unmasked", "valid_kv_600", "valid_kv_129",
                              "valid_kv_1"])
def test_attention_nt_ref_matches_jax_kernel(s, valid):
    """Head-major [BH, S, D] at D=64; with valid_kv the keys past it are
    zero rows (a sequence of 600 padded to the 512 grid; one key past a
    128-key tile; a single key, whose second 512-key block the TPU kernel
    masks whole), which must get no weight."""
    (jq, _, _), (tq, tk, tv) = _inputs((2, s, 64), 0, "float32")
    if valid is not None:
        tk[:, valid:] = 0.0
        tv[:, valid:] = 0.0
    jk, jv = jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy())
    want = j_attn._self_attention_nt(jq, jk, jv, 0.125, valid_kv=valid,
                                     interpret=True)
    got = t_attn.attention_nt_ref(tq, tk, tv, 0.125, valid)
    _close(got, want, "float32")


@pytest.mark.parametrize("d", [40, 80])
def test_attention_bshd_ref_matches_jax_kernel(d):
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 512, 2, d), 1, "float32")
    want = j_attn._self_attention_bshd(jq, jk, jv, d ** -0.5, interpret=True)
    got = t_attn.attention_bshd_ref(tq, tk, tv, d ** -0.5)
    assert got.shape == (1, 512, 2, d)
    _close(got, want, "float32")
    with pytest.raises(ValueError, match="512"):
        t_attn.attention_bshd_ref(tq[:, :500], tk[:, :500], tv[:, :500], 0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [600, 1024])
def test_repack_refs_match_jax_kernels_bit_exact(s, dtype):
    (jx, _, _), (tx, _, _) = _inputs((2, s, 2 * 40), 2, dtype)
    want = j_attn.repack_to_heads(jx, 2, interpret=True)
    got = t_attn.repack_to_heads_ref(tx, 2)
    assert got.shape == (2, 2, s, 40) and got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    back = t_attn.repack_from_heads_ref(got)
    np.testing.assert_array_equal(
        back.float().numpy(),
        np.asarray(j_attn.repack_from_heads(want, interpret=True)
                   .astype(jnp.float32)))
    assert torch.equal(back, tx)


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("s", [512, 600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["exact", "int8_switch"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_self_attention_matches_jax_under_every_switch(monkeypatch, layout,
                                                       int8, dtype, s):
    """The port's dispatch against the JAX package's ``self_attention``
    (its kernels in interpret mode) on [1, S, 2, 40]: S=600 pads to 1024
    with 424 masked keys, and under bshd falls through to bhsd (B8 with
    the int8 switch in bf16)."""
    _set_env(monkeypatch, layout, int8)
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, s, 2, 40), 3, dtype)
    want = j_attn.self_attention(jq, jk, jv, 40 ** -0.5, interpret=True)
    got = t_attn.self_attention(tq, tk, tv, 40 ** -0.5)
    assert got.shape == (1, s, 2, 40) and got.dtype == tq.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("layout,s", [("nt", 600), ("nt_repack", 600),
                                      ("bshd", 512)])
def test_int8_switch_leaves_nt_and_bshd_exact(monkeypatch, layout, s):
    """With SDT_INT8_ATTN=1 the JAX package quantizes Q K^T only in the
    bhsd layout: nt never, bshd only where it falls through (S % 512 !=
    0). So in bf16 the port's result must be the exact attention's, far
    closer to ``attention_ref`` than to ``attention_i8_ref`` (whose
    distance is ~4e-3 here), and match the JAX package's."""
    _set_env(monkeypatch, layout, True)
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, s, 2, 40), 4, "bfloat16")
    got = t_attn.self_attention(tq, tk, tv, 40 ** -0.5).float()
    _close(got, j_attn.self_attention(jq, jk, jv, 40 ** -0.5,
                                      interpret=True), "bfloat16")
    d_exact = (got - t_attn.attention_ref(tq, tk, tv, 40 ** -0.5)
               .float()).abs().max().item()
    d_i8 = (got - t_attn.attention_i8_ref(tq, tk, tv, 40 ** -0.5)
            .float()).abs().max().item()
    assert d_exact * 20 <= d_i8, (d_exact, d_i8)


def _record(monkeypatch, calls: list, name: str) -> None:
    fn = getattr(t_attn, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)
    monkeypatch.setattr(t_attn, name, wrapped)


@pytest.mark.parametrize("layout,int8,dtype,s,want", [
    ("bhsd", False, torch.bfloat16, 600, ["attention_ref"]),
    ("bhsd", True, torch.bfloat16, 600, ["attention_i8_ref"]),
    ("bhsd", True, torch.float32, 600, ["attention_ref"]),
    ("nt", True, torch.bfloat16, 600, ["attention_nt"]),
    ("nt_repack", True, torch.bfloat16, 600,
     ["repack_to_heads"] * 3 + ["attention_nt", "repack_from_heads"]),
    ("bshd", True, torch.bfloat16, 512, ["attention_bshd"]),
    ("bshd", True, torch.bfloat16, 600, ["attention_i8_ref"]),
    ("bshd", False, torch.float32, 600, ["attention_ref"]),
    ("nt_repack", False, torch.float32, 1024, ["chunked_attention"]),
])
def test_dispatch_takes_the_jax_branches(monkeypatch, layout, int8, dtype, s,
                                         want):
    """Which function each switch combination reaches, in the JAX
    package's order (a wide head first, then bshd, then nt, then bhsd);
    the last case is the VAE mid-block's one head at D=512."""
    _set_env(monkeypatch, layout, int8)
    calls = []
    for name in ("attention_ref", "attention_i8_ref", "attention_nt",
                 "attention_bshd", "repack_to_heads", "repack_from_heads",
                 "chunked_attention"):
        _record(monkeypatch, calls, name)
    d = 512 if want == ["chunked_attention"] else 40
    x = torch.randn(1, s, 1 if d == 512 else 2, d).to(dtype)
    out = t_attn.self_attention(x, x, x, d ** -0.5)
    assert out.dtype == dtype and out.shape == x.shape
    # the chunked path and bshd's plain version call attention_ref inside
    assert [c for c in calls if c != "attention_ref"
            or want == ["attention_ref"]] == want
