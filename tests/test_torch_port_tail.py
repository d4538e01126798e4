"""The port's last modules against the JAX package on the CPU: run-log
parsing and the shard merge (``tools/logs.py``), the image stacks, the
profiling hooks, the path-based NudeNet classifiers and the detector, the
data-prep helpers, the native BPE engine and the model-FLOP counter.

Tolerances: classifier probabilities 1e-6; the detector's f32 scores 1e-6
and its boxes 1e-3 px; the cv2-free linear resize 1e-4 against
``cv2.resize``; FLOP counts 1e-6 relative (they come out equal). Everything
else is compared for equality. The one intended difference: an array
handed to the port's classifier is a cv2 BGR frame, turned to RGB as
upstream's ``image_utils.load_img`` does, which the JAX package skips.
"""

import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from safe_denoiser_tpu.evals import nudenet_classifier as j_cls
from safe_denoiser_tpu.tools import data_prep as j_prep
from safe_denoiser_tpu.tools import logs as j_logs
from safe_denoiser_tpu.utils import images as j_images
from safe_denoiser_tpu_torch.data.images import read_png, write_png
from safe_denoiser_tpu_torch.evals import nudenet_classifier as t_cls
from safe_denoiser_tpu_torch.evals import nudenet_detector as t_det
from safe_denoiser_tpu_torch.tools import data_prep as t_prep
from safe_denoiser_tpu_torch.tools import logs as t_logs
from safe_denoiser_tpu_torch.utils import images as t_images
from safe_denoiser_tpu_torch.utils import profiling as t_prof
from tests.test_tools import SAMPLE_LOG
from tests.test_torch_port_runner import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_PACKAGES = ("PIL", "PIL.Image", "PIL.ImageFilter", "pandas", "cv2")


def _block(monkeypatch, names=NO_PACKAGES):
    """Make ``import name`` raise ImportError, as on a machine without
    these packages."""
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def _pngs(tmp_path, n=3, size=(40, 40), seed=0):
    from PIL import Image

    rs = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(rs.randint(0, 255, (*size, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    return paths


def _classifier_graph(tmp_path):
    from tests.test_nudenet_graph import _build_graph_and_torch

    mp = tmp_path / "cls.onnx"
    mp.write_bytes(_build_graph_and_torch()[0])
    return str(mp)


# ------------------------------------------------------------------- logs
def test_parse_log_and_csv_match_jax(tmp_path):
    import dataclasses

    got = [dataclasses.asdict(r) for r in t_logs.parse_log(SAMPLE_LOG)]
    want = [dataclasses.asdict(r) for r in j_logs.parse_log(SAMPLE_LOG)]
    assert got == want and len(got) == 2
    log = tmp_path / "logs.txt"
    log.write_text(SAMPLE_LOG)
    assert t_logs.parse_log_file_to_csv(str(log), str(tmp_path / "t.csv")) \
        == j_logs.parse_log_file_to_csv(str(log), str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_merge_detect_dicts_matches_jax():
    from safe_denoiser_tpu_torch.runners.common import DetectAggregator

    cases = [(["sexual"], True, 0.9), (["sexual", "violence"], False, 0.2),
             (["violence"], True, 0.7), (["sexual"], True, 0.8),
             (["harassment"], False, 0.1)]
    shards = [DetectAggregator(), DetectAggregator(), DetectAggregator()]
    for i, (cats, unsafe, pred) in enumerate(cases):
        shards[i % 3].add(cats, unsafe, pred)
    dicts = [s.finalize() for s in shards]
    assert t_logs.merge_detect_dicts(dicts) == j_logs.merge_detect_dicts(dicts)


def test_merge_cli_runs_as_a_module(tmp_path):
    """``python -m safe_denoiser_tpu_torch.tools.logs merge`` writes what
    JAX's ``merge_detect_dict_files`` writes."""
    from safe_denoiser_tpu_torch.runners.common import DetectAggregator

    paths = []
    for k in range(2):
        a = DetectAggregator()
        a.add(["sexual"], k == 0, 0.5 + k / 10)
        a.add(["violence"], True, 0.25)
        p = tmp_path / f"shard{k}.json"
        p.write_text(json.dumps(a.finalize()))
        paths.append(str(p))
    out = tmp_path / "merged.json"
    r = subprocess.run([sys.executable, "-m",
                        "safe_denoiser_tpu_torch.tools.logs", "merge",
                        str(out), *paths],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "merged 2 shards" in r.stdout
    want = j_logs.merge_detect_dict_files(str(tmp_path / "j.json"), paths)
    assert json.loads(out.read_text()) == want
    assert out.read_text() == (tmp_path / "j.json").read_text()


# ----------------------------------------------------------------- images
def test_stacks_match_jax():
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in ((4, 3), (5, 6), (4, 2))]
    np.testing.assert_array_equal(t_images.horz_stack(imgs),
                                  j_images.horz_stack(imgs))
    tall = [im.transpose(1, 0, 2) for im in imgs]
    np.testing.assert_array_equal(t_images.vert_stack(tall),
                                  j_images.vert_stack(tall))


# -------------------------------------------------------------- profiling
def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    """``annotate`` is the recorder's span: it lands in ``trace.json`` on
    this thread's track, on the profiler's clock (the profiler's own
    ``aten::mm`` inside it within 1 ms)."""
    import threading

    with t_prof.trace(str(tmp_path / "tr")):
        with t_prof.annotate("tail-region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / "tr" / t_prof.TRACE_FILE).read_text()
                        )["traceEvents"]
    region = [e for e in events if e.get("name") == "tail-region"]
    assert len(region) == 1 and region[0]["cat"] == "sdt"
    assert region[0]["tid"] == threading.get_native_id()
    a, b = region[0]["ts"], region[0]["ts"] + region[0]["dur"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(a - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= b + 1e3
                      for e in mm)


# ------------------------------------------------------------- classifier
def test_load_images_matches_jax(tmp_path):
    """PNG paths (40 -> 64 and 40 -> 24, NEAREST), a JPEG through PIL, a
    missing file skipped: the same frames, bit for bit."""
    from PIL import Image

    paths = _pngs(tmp_path, n=2)
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(np.full((30, 20, 3), 100, np.uint8)).save(jpg)
    bad = str(tmp_path / "missing.png")
    for size in ((64, 64), (24, 48)):
        names = paths + [jpg, bad]
        got = t_cls.load_images(names, size, image_names=names)
        want = j_cls.load_images(names, size, image_names=names)
        assert got[1] == want[1] == paths + [jpg]
        assert got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])


def test_classifier_matches_jax(tmp_path):
    mp = _classifier_graph(tmp_path)
    paths = _pngs(tmp_path, n=3, size=(48, 32))
    got = t_cls.Classifier(mp).classify(paths, batch_size=2)
    want = j_cls.Classifier(mp).classify(paths, batch_size=2)
    assert list(got) == list(want) == paths
    for p in paths:
        assert list(got[p]) == list(want[p])          # argsort order
        for k in got[p]:
            assert abs(got[p][k] - want[p][k]) <= 1e-6
    assert t_cls.Classifier(mp).classify(paths[0]) == \
        {paths[0]: got[paths[0]]}
    assert t_cls.Classifier(mp).classify([str(tmp_path / "no.png")]) == {}


def test_a_bgr_frame_is_the_one_expected_difference(tmp_path):
    """An array is a cv2 BGR frame: the port equals JAX on the frame's RGB
    form, ``frame[..., ::-1]``, and differs from JAX on the frame itself
    (JAX skips upstream's BGR->RGB step)."""
    mp = _classifier_graph(tmp_path)
    frame = np.random.RandomState(1).randint(0, 255, (40, 40, 3),
                                             dtype=np.uint8)
    got, _ = t_cls.load_images([frame], (64, 64))
    rgb, _ = j_cls.load_images([np.ascontiguousarray(frame[..., ::-1])],
                               (64, 64))
    as_is, _ = j_cls.load_images([frame], (64, 64))
    np.testing.assert_array_equal(got, rgb)
    assert not np.array_equal(got, as_is)
    p_got = t_cls.Classifier(mp)._predict(got, 4, ("unsafe", "safe"))
    p_want = j_cls.Classifier(mp)._predict(rgb, 4, ("unsafe", "safe"))
    np.testing.assert_allclose(p_got[1], p_want[1], atol=1e-6)


def test_classify_video_equals_classify_on_the_frame_as_png(tmp_path):
    cv2 = pytest.importorskip("cv2")
    mp = _classifier_graph(tmp_path)
    vp = str(tmp_path / "one.avi")
    w = cv2.VideoWriter(vp, cv2.VideoWriter_fourcc(*"MJPG"), 4.0, (48, 40))
    assert w.isOpened()
    w.write(np.random.RandomState(2).randint(0, 255, (40, 48, 3),
                                             dtype=np.uint8))
    w.release()
    ok, frame = cv2.VideoCapture(vp).read()         # the decoded frame, BGR
    assert ok
    png = str(tmp_path / "frame.png")
    write_png(np.ascontiguousarray(frame[..., ::-1]), png)
    c = t_cls.Classifier(mp)
    video = c.classify_video(vp)
    assert video["metadata"]["video_path"] == vp
    assert list(video["preds"]) == [1]
    assert video["preds"][1] == c.classify(png)[png]


def test_lite_classifier_matches_jax(tmp_path):
    from tests.test_onnx_torch_export import SepConvNet, _export

    torch.manual_seed(0)
    m = SepConvNet().eval()
    mp = tmp_path / "lite.onnx"
    _export(m, (torch.randn(1, 3, 32, 32),), mp, input_names=["input"],
            output_names=["prob"])
    paths = _pngs(tmp_path, n=2, size=(36, 36))
    got = t_cls.LiteClassifier(str(mp)).classify(paths, size=(32, 32))
    want = j_cls.LiteClassifier(str(mp)).classify(paths, size=(32, 32))
    assert list(got) == list(want) == paths
    for p in paths:
        for k in ("unsafe", "safe"):
            assert abs(got[p][k] - want[p][k]) <= 1e-6


def test_classifier_without_pil_or_cv2(tmp_path, monkeypatch):
    """PNGs need neither PIL nor cv2; a JPEG and a video raise
    ImportError without them."""
    from PIL import Image

    mp = _classifier_graph(tmp_path)
    paths = _pngs(tmp_path, n=2)
    want = t_cls.Classifier(mp).classify(paths)
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg)
    _block(monkeypatch)
    c = t_cls.Classifier(mp)
    assert c.classify(paths) == want
    with pytest.raises(ImportError, match="PIL"):
        c.classify([jpg])
    with pytest.raises(ImportError, match="cv2"):
        c.classify_video(str(tmp_path / "clip.avi"))


# --------------------------------------------------------------- detector
@pytest.mark.parametrize("shape", [(64, 48, 3), (37, 53, 3), (600, 900, 3)])
def test_linear_resize_matches_cv2(shape):
    """``cv2.resize(img, None, fx=s, fy=s)`` on f32 at the detector's
    default and fast scales and a shrink; 1e-4."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(0).rand(*shape).astype(np.float32) * 255 \
        - 120
    for scale in (t_det.compute_resize_scale(shape),
                  t_det.compute_resize_scale(shape, 480, 800), 0.37):
        want = cv2.resize(img, None, fx=scale, fy=scale)
        got = t_det.resize_linear(img, scale)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-4


def _detector_image(tmp_path, hw=(64, 48), seed=0):
    from PIL import Image

    img = np.random.RandomState(seed).randint(0, 255, (*hw, 3),
                                              dtype=np.uint8)
    path = str(tmp_path / f"img{seed}.png")
    Image.fromarray(img).save(path)
    return path


@pytest.mark.parametrize("graph", ["toy", "retinanet"])
def test_detector_matches_jax(tmp_path, graph):
    """``detect`` in both modes on the JAX tests' toy graph (outputs listed
    scores first) and on the retinanet-style graph (conv, Exp decode, NMS,
    gathers): scores 1e-6, boxes 1e-3 px before the int cast, labels."""
    pytest.importorskip("cv2")
    from safe_denoiser_tpu.evals import nudenet_detector as j_det
    from tests.test_nudenet_detector import (_retinanet_style_graph,
                                             _toy_detector_graph)

    model = (_toy_detector_graph()[0] if graph == "toy"
             else _retinanet_style_graph())
    ckpt = tmp_path / "det.onnx"
    ckpt.write_bytes(model)
    path = _detector_image(tmp_path, (120, 100) if graph != "toy"
                           else (64, 48))
    got, want = t_det.Detector(str(ckpt)), j_det.Detector(str(ckpt))
    for mode, kw in (("default", {}), ("fast", dict(min_side=480,
                                                    max_side=800))):
        (gi, gs), (wi, ws) = (t_det.preprocess_image(path, **kw),
                              j_det.preprocess_image(path, **kw))
        assert gs == ws and np.abs(gi - wi).max() <= 1e-4
        gl, gsc, gb = got._run(gi[None])
        wl, wsc, wb = want._run(wi[None])
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gsc, wsc, atol=1e-6, rtol=0)
        np.testing.assert_allclose(gb / gs, wb / ws, atol=1e-3, rtol=0)
        g, w = (got.detect(path, mode=mode, min_prob=0.01),
                want.detect(path, mode=mode, min_prob=0.01))
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            assert a["box"] == b["box"] and a["label"] == b["label"]
            assert abs(a["score"] - b["score"]) <= 1e-6
    assert got.detect(path, min_prob=1.01) == []


def test_censor_matches_jax_and_runs_without_cv2_or_pil(tmp_path,
                                                        monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from safe_denoiser_tpu.evals import nudenet_detector as j_det
    from tests.test_nudenet_detector import _toy_detector_graph

    ckpt = tmp_path / "det.onnx"
    ckpt.write_bytes(_toy_detector_graph()[0])
    path = _detector_image(tmp_path)
    want = j_det.Detector(str(ckpt)).censor(path, out_path=str(
        tmp_path / "j.png"))
    want_file = cv2.imread(str(tmp_path / "j.png"))
    _block(monkeypatch)
    det = t_det.Detector(str(ckpt))
    got = det.censor(path, out_path=str(tmp_path / "t.png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")),
                                  want_file[..., ::-1])
    assert (got == 0).all(axis=-1).any()             # a box was blanked
    assert det.censor(path) is None
    with pytest.raises(ImportError, match="cv2"):
        det.detect_video(str(tmp_path / "v.avi"))


@pytest.mark.parametrize("box", [(2, 3, 9, 7), (9, 7, 2, 3), (-5, -2, 3, 4),
                                 (40, 60, 100, 90), (60, 5, 70, 9)])
def test_filled_box_matches_cv2_rectangle(box):
    cv2 = pytest.importorskip("cv2")
    img = np.full((64, 48, 3), 200, np.uint8)
    want = cv2.rectangle(img.copy(), box[:2], box[2:], (0, 0, 0),
                         cv2.FILLED)
    got = img.copy()
    t_det._fill_box(got, box)
    np.testing.assert_array_equal(got, want)


def test_frame_similarity_matches_jax():
    pytest.importorskip("cv2")
    from safe_denoiser_tpu.evals import nudenet_detector as j_det

    rs = np.random.RandomState(1)
    a = rs.randint(0, 255, (80, 70, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rs.randint(-40, 40, a.shape), 0, 255
                ).astype(np.uint8)
    assert t_det._ssim(a[..., 0], b[..., 0]) == j_det._ssim(a[..., 0],
                                                            b[..., 0])
    for f1, f2 in ((a, a.copy()), (a, b)):
        assert t_det.is_similar_frame(f1, f2, return_score=True) == \
            j_det.is_similar_frame(f1, f2, return_score=True)


# -------------------------------------------------------------- data prep
CSV_TEXT = ('prompt,case_number,evaluation_seed,note\n'
            '"a cat, on a mat",0,7,x\n'
            'the dog runs fast,1,,y\n'
            '"quoted ""word"" here",2,3,\n'
            + "".join(f"prompt number {i} {'w ' * (i % 5)},{i},{i + 1},z\n"
                      for i in range(3, 30)))


def _frame_equal(path_a, path_b):
    import pandas as pd
    pd.testing.assert_frame_equal(pd.read_csv(path_a), pd.read_csv(path_b))


def _rows_equal(table, df):
    import pandas as pd
    assert table.columns == list(df.columns)
    assert table.index == list(df.index)
    for row, (_, want) in zip(table.rows, df.iterrows()):
        for c in table.columns:
            if pd.isna(want[c]):
                assert isinstance(row[c], float) and np.isnan(row[c])
            else:
                assert row[c] == want[c], c


@pytest.mark.parametrize("n,seed", [(10, 42), (5, 0), (100, 1)])
def test_sample_coco_subset_matches_pandas(tmp_path, n, seed):
    src = tmp_path / "coco.csv"
    src.write_text(CSV_TEXT)
    got = t_prep.sample_coco_subset(str(src), str(tmp_path / "t.csv"), n,
                                    seed)
    want = j_prep.sample_coco_subset(str(src), str(tmp_path / "j.csv"), n,
                                     seed)
    _rows_equal(got, want)
    _frame_equal(tmp_path / "t.csv", tmp_path / "j.csv")


def test_copro_json_stats_and_longest_match_pandas(tmp_path):
    jf = tmp_path / "copro.json"
    jf.write_text(json.dumps([
        {"unsafe_prompt": "bad, thing", "safe_prompt": "ok",
         "concept": "x", "category": "sexual"},
        {"idx": 7, "prompt": "other", "category": "hate"}]))
    got = t_prep.parse_copro_json(str(jf), str(tmp_path / "t.csv"))
    want = j_prep.parse_copro_json(str(jf), str(tmp_path / "j.csv"))
    _rows_equal(got, want)
    _frame_equal(tmp_path / "t.csv", tmp_path / "j.csv")

    src = tmp_path / "i2p.csv"
    src.write_text(CSV_TEXT)
    assert t_prep.prompt_word_stats(str(src)) == \
        j_prep.prompt_word_stats(str(src))
    assert t_prep.prompt_word_stats(str(src), "note") == \
        j_prep.prompt_word_stats(str(src), "note")
    for frac in (0.1, 0.25, 0.5):
        got = t_prep.select_longest_prompts(str(src), str(tmp_path / "t.csv"),
                                            top_frac=frac)
        want = j_prep.select_longest_prompts(str(src),
                                             str(tmp_path / "j.csv"),
                                             top_frac=frac)
        _rows_equal(got, want)
        _frame_equal(tmp_path / "t.csv", tmp_path / "j.csv")


def test_organize_and_grid_match_jax(tmp_path, monkeypatch):
    """The grid: PIL's default (bicubic) resize in numpy, bit for bit; the
    blur through PIL, which the port needs for it and only for it."""
    from PIL import Image

    src = tmp_path / "src"
    src.mkdir()
    rs = np.random.RandomState(3)
    for name in ("0_sexual.png", "1_violence.png", "2_sexual-blood.png",
                 "3_other.png"):
        Image.fromarray(rs.randint(0, 255, (40, 30, 3), dtype=np.uint8)
                        ).save(src / name)
    kw = {"sexual": ["sexual"], "violence": ["violence"]}
    assert t_prep.organize_by_category(str(src), str(tmp_path / "t"), kw) \
        == j_prep.organize_by_category(str(src), str(tmp_path / "j"), kw)
    for cat in kw:
        assert sorted(os.listdir(tmp_path / "t" / cat)) == \
            sorted(os.listdir(tmp_path / "j" / cat))
    paths = sorted(str(p) for p in src.glob("*.png"))[:3]
    for blur in (0.0, 1.0):
        got = t_prep.make_image_grid(paths, str(tmp_path / "t.png"), cols=2,
                                     cell=16, blur_radius=blur)
        want = j_prep.make_image_grid(paths, str(tmp_path / "j.png"),
                                      cols=2, cell=16, blur_radius=blur)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")),
                                      np.asarray(Image.open(tmp_path /
                                                            "j.png")))
    _block(monkeypatch)
    t_prep.make_image_grid(paths, str(tmp_path / "n.png"), cols=2, cell=16)
    with pytest.raises(ImportError, match="PIL"):
        t_prep.make_image_grid(paths, str(tmp_path / "n.png"), cols=2,
                               cell=16, blur_radius=1.0)


def test_csv_helpers_without_pandas(tmp_path, monkeypatch):
    src = tmp_path / "coco.csv"
    src.write_text(CSV_TEXT)
    _block(monkeypatch)
    sub = t_prep.sample_coco_subset(str(src), str(tmp_path / "s.csv"), 4)
    assert len(sub) == 4
    assert t_prep.prompt_word_stats(str(src))["n"] == 30
    assert len(t_prep.select_longest_prompts(str(src),
                                             str(tmp_path / "l.csv"))) >= 3


class _StubPipe:
    """``pipe(prompt, ...)``: one seeded uint8 image a call."""

    def __call__(self, prompt, num_inference_steps, guidance_scale, seed):
        rs = np.random.RandomState(seed + len(prompt))
        return [rs.randint(0, 255, (16, 16, 3), dtype=np.uint8)]


class _Log:
    def __init__(self):
        self.lines = []

    def log(self, msg):
        self.lines.append(msg)


def _stub_gate(imgs, threshold):
    pred = float(imgs[0].mean()) / 255.0
    return pred >= threshold, pred


def test_generate_negative_bank_matches_jax(tmp_path, monkeypatch):
    from PIL import Image

    prompts = ["a", "bb", "ccc", "dddd", "eeeee"]
    logs = _Log(), _Log()
    want = j_prep.generate_negative_bank(
        _StubPipe(), prompts, _stub_gate, str(tmp_path / "j"),
        threshold=0.5, seed=3, logger=logs[1])
    _block(monkeypatch)
    got = t_prep.generate_negative_bank(
        _StubPipe(), prompts, _stub_gate, str(tmp_path / "t"),
        threshold=0.5, seed=3, logger=logs[0])
    assert got == want and 0 < got < len(prompts)
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j"))
    monkeypatch.undo()
    for f in files:
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "t" / f)),
            np.asarray(Image.open(tmp_path / "j" / f)))
    assert logs[0].lines == logs[1].lines


# ----------------------------------------------------------------- native
NATIVE_PROMPTS = ["a cat", "The DOG runs to the cat", "cat's dog!",
                  "weird   spacing\tand", "punct!!! ...--- cat",
                  "123 cats 456", "", "naïve café prompt",
                  "mixed CASE The THE the"]


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("text", NATIVE_PROMPTS)
def test_native_ids_equal_the_python_path(text):
    from safe_denoiser_tpu_torch.text import CLIPTokenizer
    from tests.test_native_bpe import _tok

    j_tok = _tok()
    tok = CLIPTokenizer(sorted(j_tok.bpe_ranks, key=j_tok.bpe_ranks.get),
                        j_tok.vocab, max_length=32)
    assert tok.engine == "native"
    assert tok.encode(text) == tok.encode_python(text) == j_tok.encode(text)
    assert tok(text) == j_tok(text)


def test_tokenizer_warns_and_takes_the_python_path_without_g_plus_plus(
        tmp_path, monkeypatch):
    from safe_denoiser_tpu_torch.text import CLIPTokenizer, native
    from tests.test_native_bpe import _tok

    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "bpe")
    monkeypatch.setattr(native.subprocess, "run", no_gxx)
    j_tok = _tok()
    tok = CLIPTokenizer(sorted(j_tok.bpe_ranks, key=j_tok.bpe_ranks.get),
                        j_tok.vocab, max_length=32)
    with pytest.warns(UserWarning, match="no g\\+\\+"):
        assert tok.engine == "python"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tok.encode("The DOG runs") == j_tok.encode("The DOG runs")


# ------------------------------------------------------------------ flops
def _jax_unet_flops(side):
    import jax
    import jax.numpy as jnp

    from safe_denoiser_tpu.models import UNet2DCondition, UNetConfig
    from safe_denoiser_tpu.utils.flops import model_flops

    model = UNet2DCondition(UNetConfig(**FLOPS_UNET))
    x, ctx = jnp.zeros((2, side, side, 4)), jnp.zeros((2, 7, 16))
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                               jnp.asarray(1), ctx))
    return model_flops(model.apply, params, x, jnp.asarray(500), ctx)


# tests/test_flops.py's tiny UNet
FLOPS_UNET = dict(sample_size=8, block_out_channels=(16, 32),
                  layers_per_block=1, cross_attention_dim=16,
                  num_attention_heads=4, norm_num_groups=8)


@pytest.mark.parametrize("side", [8, 24])
def test_unet_flops_match_jax(side):
    """At 24^2 the level-0 self-attention (S = 576) goes through the kernel
    wrapper, which takes its plain version on meta inside the count."""
    from safe_denoiser_tpu_torch.models import unet as t_unet
    from safe_denoiser_tpu_torch.ops import _build
    from safe_denoiser_tpu_torch.utils.flops import model_flops

    with torch.device("meta"):
        m = t_unet.UNet2DConditionModel(t_unet.UNetConfig(**FLOPS_UNET))
    got = model_flops(m, torch.empty(2, 4, side, side), 500,
                      torch.empty(2, 7, 16))
    want = _jax_unet_flops(side)
    assert want > 0 and abs(got - want) <= 1e-6 * want
    assert _build._PLAIN_DEVICES == {"cpu"}          # restored


def test_mmdit_and_vae_decoder_flops_match_jax():
    import jax
    import jax.numpy as jnp

    from safe_denoiser_tpu.models import mmdit as j_mmdit
    from safe_denoiser_tpu.models import vae as j_vae
    from safe_denoiser_tpu.utils.flops import model_flops as j_flops
    from safe_denoiser_tpu_torch.models import mmdit as t_mmdit
    from safe_denoiser_tpu_torch.models import vae as t_vae
    from safe_denoiser_tpu_torch.utils.flops import model_flops
    from tests.test_torch_port_models import VAE_KW
    from tests.test_torch_port_sd3 import MMDIT_KW

    model = j_mmdit.MMDiT(j_mmdit.MMDiTConfig(**MMDIT_KW))
    args = (jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)), jnp.zeros((2, 5, 24)),
            jnp.zeros((2, 20)))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    want = j_flops(model.apply, params, *args)
    with torch.device("meta"):
        m = t_mmdit.MMDiT(t_mmdit.MMDiTConfig(**MMDIT_KW))
    got = model_flops(m, torch.empty(2, 4, 8, 8), torch.empty(2),
                      torch.empty(2, 5, 24), torch.empty(2, 20))
    assert want > 0 and abs(got - want) <= 1e-6 * want

    vae = j_vae.AutoencoderKL(j_vae.VAEConfig(**VAE_KW))
    rng = jax.random.PRNGKey(0)
    params = jax.eval_shape(vae.init, {"params": rng},
                            jnp.zeros((1, 16, 16, 3)), rng)
    want = j_flops(lambda p, z: vae.apply(
        p, z, method=j_vae.AutoencoderKL.decode), params,
        jnp.zeros((2, 8, 8, 4)))
    with torch.device("meta"):
        v = t_vae.AutoencoderKL(t_vae.VAEConfig(**VAE_KW))
    got = model_flops(v.decode, torch.empty(2, 4, 8, 8))
    assert want > 0 and abs(got - want) <= 1e-6 * want


def test_plain_on_meta_is_scoped_and_never_takes_a_cuda_tensor():
    """Outside the context a meta tensor is not the plain version's (the
    wrapper heads for the kernel and rejects it); inside, a CUDA tensor
    (a fake one: the CPU host has no GPU) still heads for the kernel and
    raises, and no launch is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from safe_denoiser_tpu_torch.ops import _build, attention

    q = torch.empty(1, 512, 2, 8, device="meta")
    with pytest.raises(ValueError, match="GPU"):
        attention.self_attention(q, q, q, 0.3)
    with _build.plain_on_meta():
        assert attention.self_attention(q, q, q, 0.3).shape == q.shape
        with FakeTensorMode():
            qc = torch.empty(1, 512, 2, 8, device="cuda",
                             dtype=torch.bfloat16)
            assert not _build.takes_plain(qc)
            before = attention.launches
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with pytest.raises(RuntimeError):
                    attention.self_attention(qc, qc, qc, 0.3)
            assert attention.launches == before
    assert _build._PLAIN_DEVICES == {"cpu"}
    with pytest.raises(RuntimeError):
        with _build.plain_on_meta():
            raise RuntimeError("inside")
    assert _build._PLAIN_DEVICES == {"cpu"}


def test_int_mm_counts_and_mfu_matches_jax(monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    from safe_denoiser_tpu.utils import flops as j_flops
    from safe_denoiser_tpu_torch.utils import flops as t_flops

    a = torch.empty(32, 64, dtype=torch.int8, device="meta")
    b = torch.empty(64, 48, dtype=torch.int8, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        torch._int_mm(a, b)
    assert counter.get_total_flops() == 2 * 32 * 64 * 48
    peak = 123e12
    assert t_flops.mfu(2.0, peak / 4, peak) == j_flops.mfu(2.0, peak / 4,
                                                           peak) == 0.5
    assert t_flops.mfu(1.0, 989e12) == 1.0          # the H100 bf16 peak
    monkeypatch.setenv("SDT_PEAK_FLOPS", "1e12")
    assert t_flops.mfu(3.0, 1e11) == j_flops.mfu(3.0, 1e11) == \
        pytest.approx(0.3)
