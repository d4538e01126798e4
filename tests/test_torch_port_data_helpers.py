"""The port's bank and CSV helpers against the JAX package's on the same
files: ``get_dataloader``, ``get_all_imgs`` and ``load_image_bank``
(``data/images.py``; the JAX package reads PNGs through PIL, the port
through its own decoder and PIL-exact bilinear resize) and
``load_prompt_csv`` (``data/prompts.py``; pandas against the port's typed
CSV reader)."""

import math

import numpy as np
from PIL import Image

from safe_denoiser_tpu import data as j_data
from safe_denoiser_tpu_torch import data as t_data


def _bank(tmp_path, n=5):
    d = tmp_path / "bank" / "i2p"
    d.mkdir(parents=True)
    rs = np.random.RandomState(0)
    for i in range(n):
        arr = rs.randint(0, 256, (40 + 3 * i, 50, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"img_{i:03d}.png")
    return str(tmp_path / "bank")


def test_image_bank_helpers_match_the_jax_package(tmp_path):
    root = _bank(tmp_path)
    kw = dict(root=root, class_info="i2p")
    want = j_data.load_image_bank("nudity", size=32, **kw)
    got = t_data.load_image_bank("nudity", size=32, **kw)
    assert got.shape == (5, 3, 32, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    ds_t = t_data.get_dataset("nudity", transforms=t_data.get_transform(
        size=24), **kw)
    ds_j = j_data.get_dataset("nudity", transforms=j_data.get_transform(
        size=24), **kw)
    np.testing.assert_array_equal(t_data.get_all_imgs(ds_t),
                                  j_data.get_all_imgs(ds_j))
    batches_t = list(t_data.get_dataloader(ds_t, batch_size=2))
    batches_j = list(j_data.get_dataloader(ds_j, batch_size=2))
    assert [b.shape for b in batches_t] == [b.shape for b in batches_j] \
        == [(2, 3, 24, 24), (2, 3, 24, 24), (1, 3, 24, 24)]
    for bt, bj in zip(batches_t, batches_j):
        np.testing.assert_array_equal(bt, bj)


def test_load_prompt_csv_matches_pandas(tmp_path):
    path = tmp_path / "p.csv"
    path.write_text("case_number,prompt,evaluation_seed,evaluation_guidance,"
                    "categories\n"
                    "0,a cat,42,7.5,\"sexual, violence\"\n"
                    "1,a dog,,7.0,hate\n"
                    "2,,7,8,\n")
    want = j_data.load_prompt_csv(str(path))
    got = t_data.load_prompt_csv(str(path))
    assert list(got.columns) == list(want.columns)
    assert got.index == list(want.index)
    rows_j = list(want.iterrows())
    rows_t = list(got.iterrows())
    assert len(rows_t) == len(rows_j) == 3
    for (lt, rt), (lj, rj) in zip(rows_t, rows_j):
        assert lt == lj
        for col in want.columns:
            a, b = rt[col], rj[col]
            if isinstance(b, float) and math.isnan(b):
                assert isinstance(a, float) and math.isnan(a), col
            else:
                assert a == b and type(a) is type(b.item() if hasattr(
                    b, "item") else b), col
