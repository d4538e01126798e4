"""The port's six repellency processors, LSH and img_utils against the JAX
package on the CPU (f32), on the same banks made from numpy seeds.

Each processor is built through both factories (``get_repellency_method``)
with embeddings that compute the same function in both packages, and its
``conditioning`` is compared. random_noise draws from torch's Philox in the
port and threefry in JAX, so it is held to its formula on the port's
generator instead. The sparse radius and the kernel_fast beta are
calibrated in both packages from one noisy-bank ``.pt`` cache that the JAX
package's ``save_pt`` wrote, which injects JAX's noise into the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_denoiser_tpu.io import save_pt
from safe_denoiser_tpu.repellency import get_repellency_method as j_get
from safe_denoiser_tpu.repellency import img_utils as j_img
from safe_denoiser_tpu.repellency import lsh as j_lsh
from safe_denoiser_tpu.schedulers import DDPMScheduler as JDDPMScheduler
from safe_denoiser_tpu_torch.pipeline import sampler as t_sampler
from safe_denoiser_tpu_torch.repellency import get_repellency_method as t_get
from safe_denoiser_tpu_torch.repellency import img_utils as t_img
from safe_denoiser_tpu_torch.repellency import lsh as t_lsh
from safe_denoiser_tpu_torch.repellency import methods as t_methods
from safe_denoiser_tpu_torch.schedulers import DDPMScheduler
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

# f32 sums in another order: the processors' outputs agree to this
ATOL = 1e-5

METHODS = ["kernel_fast", "kernel", "euclidean", "random_noise", "sparse",
           "lsh"]


def _bank(m=20, seed=7):
    return np.random.RandomState(seed).randn(m, 3, 16, 16).astype(np.float32)


def j_embed(x):
    """[N, 3, 16, 16] -> [N, 4, 8, 8]: the first channel, every other
    pixel, four times (tests/test_repellency.py's embedding)."""
    return jnp.asarray(x)[:, :1, ::2, ::2].repeat(4, axis=1)


def t_embed(x):
    return torch.as_tensor(np.asarray(x))[:, :1, ::2, ::2].repeat(1, 4, 1, 1)


PARAMS = {
    "kernel_fast": dict(sigma=3.0, scale=0.4, beta_threshold=0.5),
    "kernel": dict(sigma=30.0, scale=0.4),
    "euclidean": dict(sigma=30.0, scale=0.4),
    "random_noise": dict(scale=0.1),
    "sparse": dict(radius=12.0, scale=0.3),
    "lsh": dict(sigma=5.0, scale=0.5, n_components=8, hash_size=4,
                num_hashtables=3),
}


def _pair(name, ref, **extra):
    kw = dict(n_embed=8, **{**PARAMS[name], **extra})
    return (j_get(name, ref_data=ref, embed_fn=j_embed, **kw),
            t_get(name, ref_data=torch.from_numpy(ref), embed_fn=t_embed,
                  device="cpu", **kw))


def _query(name, jp, rs):
    """x0 near the first bank rows, in the space the method compares in:
    image-shaped for kernel and euclidean (raw bank), latent otherwise."""
    if name in ("kernel", "euclidean"):
        base = _bank()[:3]
    else:
        base = np.asarray(jp.get_proj_ref())[:3]
    return (base + 0.2 * rs.randn(*base.shape)).astype(np.float32)


@pytest.mark.parametrize("name", METHODS)
def test_processor_matches_jax(name):
    """Bank, config and conditioning of each processor against JAX's:
    x_0_hat within ATOL and the same is_negation (kernel_fast with its beta
    gate applied)."""
    ref = _bank()
    jp, tp = _pair(name, ref)
    assert type(tp).__name__ == type(jp).__name__
    np.testing.assert_allclose(tp.get_proj_ref().numpy(),
                               np.asarray(jp.get_proj_ref()), atol=1e-6)
    assert tp.config() == t_methods.RepellencyConfig(
        **vars(jp.config()))
    x = _query(name, jp, np.random.RandomState(3))
    kw = {"beta_threshold": True} if name == "kernel_fast" else {}
    want = jp.conditioning(x, **kw)
    if name == "random_noise":
        gen = torch.Generator().manual_seed(11)
        got = tp.conditioning(torch.from_numpy(x), generator=gen)
        noise = torch.randn((3, x[0].size),
                            generator=torch.Generator().manual_seed(11))
        np.testing.assert_allclose(
            got["x_0_hat"].numpy(),
            x - 0.1 * noise.reshape(x.shape).numpy(), atol=ATOL)
        again = tp.conditioning(torch.from_numpy(x))      # seed 0 default
        np.testing.assert_array_equal(
            again["x_0_hat"].numpy(),
            tp.conditioning(torch.from_numpy(x))["x_0_hat"].numpy())
        assert not np.allclose(again["x_0_hat"].numpy(),
                               got["x_0_hat"].numpy())
        assert got["is_negation"] is want["is_negation"] is True
        return
    got = tp.conditioning(torch.from_numpy(x), **kw)
    assert got["is_negation"] == want["is_negation"]
    np.testing.assert_allclose(got["x_0_hat"].numpy(),
                               np.asarray(want["x_0_hat"]), atol=ATOL)
    assert not np.allclose(got["x_0_hat"].numpy(), x), "nothing moved"


def test_factory_names_and_refusals():
    assert set(METHODS) <= set(t_methods.__CONDITIONING_METHOD__)
    with pytest.raises(NameError, match="not defined"):
        t_get("nope", ref_data=None, embed_fn=None)
    # the sampling loops pass no generator: random_noise stays refused
    cfg = t_methods.RepellencyConfig(method="random_noise")
    with pytest.raises(ValueError, match="generator"):
        t_sampler._repellency_hook(DDPMScheduler(), torch.zeros(1, 4, 8, 8),
                                   981, torch.zeros(1, 4, 8, 8),
                                   torch.zeros(2, 4, 8, 8), cfg,
                                   torch.zeros(1, 4, 8, 8))


def test_lsh_buckets_identical_to_jax():
    """The PCA re-typing reduces the bank as scikit-learn's exact PCA (a
    [20, 256] bank: at most 500 rows and columns, so scikit-learn's default
    solver is the exact one) and every table holds the same buckets; the
    queries hash to the same members."""
    jp, tp = _pair("lsh", _bank())
    np.testing.assert_allclose(tp.pca.components_, jp.pca.components_,
                               atol=1e-5)
    for jt, tt in zip(jp.lsh.tables, tp.lsh.tables):
        assert jt == tt
    x = _query("lsh", jp, np.random.RandomState(4)).reshape(3, -1)
    jred = jp.pca.transform(x)
    assert tp.buckets(x) == [jp.lsh.query(r) for r in jred]
    assert any(tp.buckets(x))


def test_lsh_bucket_scores_match_jax():
    rs = np.random.RandomState(3)
    n, m, d = 5, 7, 12
    flat = rs.randn(n, d).astype(np.float32)
    refs = rs.randn(m, d).astype(np.float32)
    buckets = [[0, 3, 5], [], [2], [1, 2, 3, 4, 6], [6]]
    idx = np.zeros((n, 8), np.int64)
    mask = np.zeros((n, 8), np.float32)
    for i, b in enumerate(buckets):
        idx[i, :len(b)] = b
        mask[i, :len(b)] = 1.0
    kw = dict(sigma=2.0, scale=0.4, epsilon=1e-8)
    want = j_lsh._bucket_scores(jnp.asarray(flat), jnp.asarray(refs),
                                jnp.asarray(idx.astype(np.int32)),
                                jnp.asarray(mask), **kw)
    got = t_lsh._bucket_scores(torch.from_numpy(flat),
                               torch.from_numpy(refs), torch.from_numpy(idx),
                               torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[1], flat[1])   # empty bucket


def test_lsh_with_no_member_leaves_x_unchanged():
    """A query whose key no table holds (the first of seeded random
    points, 16-bit keys over 20 rows) passes through unchanged with
    is_negation False in both packages."""
    jp, tp = _pair("lsh", _bank(), hash_size=16, num_hashtables=1)
    rs = np.random.RandomState(0)
    for _ in range(50):
        x = (5.0 * rs.randn(1, 4, 8, 8)).astype(np.float32)
        if not tp.buckets(x.reshape(1, -1))[0]:
            break
    else:
        pytest.fail("no seeded query fell into an empty bucket")
    got, want = tp.conditioning(torch.from_numpy(x)), jp.conditioning(x)
    assert got["is_negation"] is want["is_negation"] is False
    np.testing.assert_array_equal(got["x_0_hat"].numpy(), x)


@pytest.mark.parametrize("name,key", [("sparse", "radius"),
                                      ("kernel_fast", "beta_threshold")])
def test_calibration_through_a_jax_written_noisy_cache(tmp_path, name, key):
    """A noisy-bank cache written by the JAX package's save_pt ({t: bank at
    level t} from JAX's noise) calibrates the sparse radius and the
    kernel_fast beta to JAX's values (relative 1e-5)."""
    ref = _bank()
    path = str(tmp_path / "noisy.pt")
    jsrc = j_get(name, ref_data=ref, embed_fn=j_embed, n_embed=8,
                 scheduler=JDDPMScheduler(), num_timesteps=2,
                 proj_noisy_ref_path_for_beta=path, quantile=0.25,
                 radius=-1.0, beta_threshold=-1.0, sigma=30.0)
    kw = dict(n_embed=8, num_timesteps=2, quantile=0.25, radius=-1.0,
              beta_threshold=-1.0, sigma=30.0,
              proj_noisy_ref_path_for_beta=path,
              cache_noisy_ref_path_for_beta=True)
    jp = j_get(name, ref_data=ref, embed_fn=j_embed, **kw)
    tp = t_get(name, ref_data=torch.from_numpy(ref), embed_fn=t_embed,
               device="cpu", **kw)
    noisy = tp.import_proj_ref(path)
    assert sorted(noisy) == sorted(int(t) for t in
                                   JDDPMScheduler().timesteps(2))
    assert getattr(jp, key) == pytest.approx(getattr(jsrc, key), rel=1e-6)
    assert getattr(tp, key) == pytest.approx(getattr(jp, key), rel=1e-5)
    assert getattr(tp, key) > 0


# ---------------------------------------------------------------- img_utils
def test_fft_pair_matches_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 3, 16, 12) + 1j * rs.randn(2, 3, 16, 12)).astype(
        np.complex64)
    for j_fn, t_fn in ((j_img.fft2c, t_img.fft2c),
                       (j_img.ifft2c, t_img.ifft2c)):
        np.testing.assert_allclose(t_fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(j_fn(jnp.asarray(x))),
                                   atol=1e-5)
    back = t_img.ifft2c(t_img.fft2c(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)


@pytest.mark.parametrize("percentile,floor", [(0.995, 1.0), (0.5, 0.1)])
def test_dynamic_thresholding_matches_jax(percentile, floor):
    x = (2.0 * np.random.RandomState(1).randn(3, 4, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        t_img.dynamic_thresholding(torch.from_numpy(x), percentile,
                                   floor).numpy(),
        np.asarray(j_img.dynamic_thresholding(jnp.asarray(x), percentile,
                                              floor)), atol=1e-6)


@pytest.mark.parametrize("size", [5, 4])
def test_blur_matches_jax(size):
    k = t_img.gaussian_blur_kernel(size, 1.3)
    np.testing.assert_array_equal(k, j_img.gaussian_blur_kernel(size, 1.3))
    x = np.random.RandomState(2).rand(2, 11, 9, 3).astype(np.float32)
    np.testing.assert_allclose(
        t_img.apply_blur(torch.from_numpy(x), k).numpy(),
        np.asarray(j_img.apply_blur(jnp.asarray(x), k)), atol=1e-6)


def test_mask_generator_matches_jax():
    for kw in (dict(mask_type="box", box_size=5, seed=3),
               dict(mask_type="random", prob=0.3, seed=4)):
        np.testing.assert_array_equal(t_img.mask_generator((12, 10), **kw),
                                      j_img.mask_generator((12, 10), **kw))
    with pytest.raises(ValueError, match="mask_type"):
        t_img.mask_generator((4, 4), mask_type="ring")


def test_save_pt_cache_reads_in_the_port(tmp_path):
    """A projected-bank cache written by the JAX package's save_pt is the
    port's bank under cache_proj_ref."""
    refs = np.random.RandomState(9).randn(6, 4, 8, 8).astype(np.float32)
    path = str(tmp_path / "proj.pt")
    save_pt(refs, path)
    tp = t_get("sparse", ref_data=None, embed_fn=None, cache_proj_ref=True,
               proj_ref_path=path, radius=5.0, n_embed=8, device="cpu")
    np.testing.assert_array_equal(tp.get_proj_ref().numpy(), refs)
