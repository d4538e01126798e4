"""NudeNet detector path (reference nudenet/detector.py:1-196,
detector_utils.py, video_utils.py) on the port's copy of the numpy ONNX
interpreter (``evals/onnx_rt.py``).

Counterpart of ``safe_denoiser_tpu/evals/nudenet_detector.py``. The
image path needs neither cv2 nor PIL; it runs on numpy alone:
  * a PNG is decoded by the port's codec (``data.images.read_rgb``; other
    formats through PIL, ``ImportError`` without it); an array input is a
    BGR frame and is used as it is (the reference's BGR→RGB→BGR round trip);
  * ``resize_image`` is ``cv2.resize(img, None, fx=s, fy=s)`` on the f32
    image written in numpy (``resize_linear``): INTER_LINEAR with
    half-pixel centres, no antialiasing, an output of round(W·s) ×
    round(H·s) and a source step of 1/s as given;
  * ``censor`` fills the boxes by slicing (``cv2.rectangle(..., FILLED)``
    covers both corners) and writes a PNG with ``write_png``.
The video paths (``detect_video``, ``get_interest_frames_from_video``,
``is_similar_frame``) read and resize frames with cv2 and raise
``ImportError`` without it. Checkpoints and classes come from local paths
(no download); frame similarity is the JAX package's numpy SSIM.
"""

from __future__ import annotations

import importlib
import logging
import os

import numpy as np

from ..data.images import read_rgb, write_png
from .onnx_rt import InferenceSession

# detector_v2_default_classes (public model metadata; the reference downloads
# this list from the NudeNet release next to the checkpoint)
DEFAULT_CLASSES = [
    "EXPOSED_ANUS", "EXPOSED_ARMPITS", "COVERED_BELLY", "EXPOSED_BELLY",
    "COVERED_BUTTOCKS", "EXPOSED_BUTTOCKS", "FACE_F", "FACE_M",
    "COVERED_FEET", "EXPOSED_FEET", "COVERED_BREAST_F", "EXPOSED_BREAST_F",
    "COVERED_GENITALIA_F", "EXPOSED_GENITALIA_F", "EXPOSED_BREAST_M",
    "EXPOSED_GENITALIA_M",
]


def _cv2(what: str):
    try:
        return importlib.import_module("cv2")
    except ImportError:
        raise ImportError(f"{what} reads video frames with OpenCV (cv2), "
                          "which is not installed") from None


# ---------------------------------------------------------------------------
# preprocessing (reference nudenet/detector_utils.py)
# ---------------------------------------------------------------------------


def read_image_bgr(path) -> np.ndarray:
    """RGB file / BGR array -> BGR array (reference detector_utils.py:7-18)."""
    if isinstance(path, str):
        return read_rgb(path)[:, :, ::-1]
    return np.asarray(path)[:, :, :3]


def _preprocess_image(x: np.ndarray, mode: str = "caffe") -> np.ndarray:
    x = x.astype(np.float32)
    if mode == "tf":
        x /= 127.5
        x -= 1.0
    elif mode == "caffe":
        x -= [103.939, 116.779, 123.68]
    return x


def compute_resize_scale(image_shape, min_side=800, max_side=1333) -> float:
    rows, cols, _ = image_shape
    scale = min_side / min(rows, cols)
    if max(rows, cols) * scale > max_side:
        scale = max_side / max(rows, cols)
    return scale


def _linear_taps(n_in: int, n_out: int, scale: float):
    """cv2's INTER_LINEAR taps along one axis: source index pairs and f32
    weights for each output index, the source position (dx + 0.5) / scale
    - 0.5 in f64 and its fraction rounded to f32, clamped at both edges."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (1.0 / scale) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = (f - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    frac[low | high] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (np.float32(1.0) - frac), frac


def resize_linear(img: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=scale, fy=scale)`` of an f32 [H, W, C]
    image: [round(H·scale), round(W·scale), C], a horizontal pass then a
    vertical one in f32."""
    h, w = img.shape[:2]
    h_out, w_out = int(round(h * scale)), int(round(w * scale))
    x0, x1, a0, a1 = _linear_taps(w, w_out, scale)
    y0, y1, b0, b1 = _linear_taps(h, h_out, scale)
    img = np.asarray(img, np.float32)
    rows = img[:, x0] * a0[None, :, None] + img[:, x1] * a1[None, :, None]
    return rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]


def resize_image(img: np.ndarray, min_side=800, max_side=1333):
    scale = compute_resize_scale(img.shape, min_side, max_side)
    return resize_linear(img, scale), scale


def preprocess_image(image_path, min_side=800, max_side=1333):
    image = _preprocess_image(read_image_bgr(image_path))
    return resize_image(image, min_side=min_side, max_side=max_side)


# ---------------------------------------------------------------------------
# video frame selection (reference nudenet/video_utils.py)
# ---------------------------------------------------------------------------


def _ssim(f1: np.ndarray, f2: np.ndarray, win: int = 7) -> float:
    """Mean structural similarity with a uniform win x win window —
    skimage.metrics.structural_similarity defaults (gaussian_weights=False),
    in numpy as the JAX package computes it."""
    f1 = f1.astype(np.float64)
    f2 = f2.astype(np.float64)
    data_range = 255.0
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2

    def _filt(a):
        # uniform filter, valid mode
        k = win
        s = np.cumsum(np.cumsum(a, axis=0), axis=1)
        s = np.pad(s, ((1, 0), (1, 0)))
        return (s[k:, k:] - s[:-k, k:] - s[k:, :-k] + s[:-k, :-k]) / (k * k)

    mu1, mu2 = _filt(f1), _filt(f2)
    s11 = _filt(f1 * f1) - mu1 * mu1
    s22 = _filt(f2 * f2) - mu2 * mu2
    s12 = _filt(f1 * f2) - mu1 * mu2
    # skimage's sample covariance normalization: N/(N-1)
    norm = (win * win) / (win * win - 1.0)
    s11, s22, s12 = s11 * norm, s22 * norm, s12 * norm
    ssim_map = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / \
        ((mu1 ** 2 + mu2 ** 2 + c1) * (s11 + s22 + c2))
    return float(ssim_map.mean())


def is_similar_frame(f1, f2, resize_to=(64, 64), thresh=0.5,
                     return_score=False):
    """reference video_utils.py:10-48 semantics (env-tunable threshold);
    frames are read and resized with cv2."""
    cv2 = _cv2("is_similar_frame")
    thresh = float(os.getenv("FRAME_SIMILARITY_THRESH", thresh))
    if f1 is None or f2 is None:
        return False
    try:
        if isinstance(f1, str):
            f1 = cv2.imread(f1)
        if isinstance(f2, str):
            f2 = cv2.imread(f2)
    except Exception as ex:
        logging.exception(ex, exc_info=True)
        return False
    if resize_to:
        f1 = cv2.resize(f1, resize_to)
        f2 = cv2.resize(f2, resize_to)
    if f1.ndim == 3:
        f1 = f1[:, :, 0]
    if f2.ndim == 3:
        f2 = f2[:, :, 0]
    score = _ssim(f1, f2)
    if return_score:
        return score
    return score >= thresh


def get_interest_frames_from_video(video_path,
                                   frame_similarity_threshold=0.5,
                                   similarity_context_n_frames=3,
                                   skip_n_frames=0.5,
                                   output_frames_to_dir=None):
    """reference video_utils.py:51-125: sample frames, drop ones similar to
    the last N kept frames (cv2)."""
    cv2 = _cv2("get_interest_frames_from_video")
    skip_n_frames = float(os.getenv("SKIP_N_FRAMES", skip_n_frames))
    important_frames, fps, video_length = [], 0, 0
    try:
        video = cv2.VideoCapture(video_path)
        fps = video.get(cv2.CAP_PROP_FPS)
        length = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
        if skip_n_frames < 1:
            skip_n_frames = int(skip_n_frames * fps)
        video_length = length
        for frame_i in range(length + 1):
            read_flag, current_frame = video.read()
            if not read_flag:
                break
            if skip_n_frames > 0 and frame_i % skip_n_frames != 0:
                continue
            frame_i += 1
            found_similar = False
            for _, context_frame in reversed(
                    important_frames[-similarity_context_n_frames:]):
                if is_similar_frame(context_frame, current_frame,
                                    thresh=frame_similarity_threshold):
                    found_similar = True
                    break
            if not found_similar:
                important_frames.append((frame_i, current_frame))
                if output_frames_to_dir:
                    os.makedirs(output_frames_to_dir, exist_ok=True)
                    cv2.imwrite(os.path.join(
                        output_frames_to_dir, f"{str(frame_i).zfill(10)}.png"),
                        current_frame)
    except Exception as ex:  # mirror the reference's tolerant behavior
        logging.exception(ex, exc_info=True)
    return ([i[0] for i in important_frames],
            [i[1] for i in important_frames], fps, video_length)


# ---------------------------------------------------------------------------
# detector (reference nudenet/detector.py)
# ---------------------------------------------------------------------------


def _sniff_outputs(outputs):
    """The reference identifies outputs by dtype, not name or position
    (detector.py:148-150): int32 -> labels; float with scalar first
    element -> scores; float with array first element -> boxes."""
    labels = [op for op in outputs if op.dtype == np.int32][0]
    scores = [op for op in outputs
              if op.dtype != np.int32 and np.ndim(op[0][0]) == 0][0]
    boxes = [op for op in outputs
             if op.dtype != np.int32 and np.ndim(op[0][0]) > 0][0]
    return labels, scores, boxes


def _fill_box(image: np.ndarray, box) -> None:
    """``cv2.rectangle(image, (x1, y1), (x2, y2), 0, cv2.FILLED)``: both
    corners included, clipped to the image."""
    x1, y1, x2, y2 = (int(c) for c in box)
    h, w = image.shape[:2]
    ys, ye = max(min(y1, y2), 0), min(max(y1, y2) + 1, h)
    xs, xe = max(min(x1, x2), 0), min(max(x1, x2) + 1, w)
    if ys < ye and xs < xe:
        image[ys:ye, xs:xe] = 0


class Detector:
    """Local-checkpoint NudeNet detector (reference detector.py:29-163)."""

    def __init__(self, checkpoint_path: str, classes_path: str | None = None):
        self.detection_model = InferenceSession(checkpoint_path)
        if classes_path and os.path.exists(classes_path):
            with open(classes_path) as f:
                self.classes = [c.strip() for c in f if c.strip()]
        else:
            self.classes = list(DEFAULT_CLASSES)

    def _run(self, batch: np.ndarray):
        outputs = self.detection_model.run(
            [o.name for o in self.detection_model.get_outputs()],
            {self.detection_model.get_inputs()[0].name: batch})
        return _sniff_outputs([np.asarray(o) for o in outputs])

    def detect(self, img_path, mode: str = "default", min_prob=None):
        if mode == "fast":
            image, scale = preprocess_image(img_path, min_side=480,
                                            max_side=800)
            min_prob = min_prob or 0.5
        else:
            image, scale = preprocess_image(img_path)
            min_prob = min_prob or 0.6
        labels, scores, boxes = self._run(np.expand_dims(image, axis=0))
        boxes = boxes / scale
        processed = []
        for box, score, label in zip(boxes[0], scores[0], labels[0]):
            if score < min_prob:
                continue
            processed.append({"box": [int(c) for c in box.astype(int)],
                              "score": float(score),
                              "label": self.classes[int(label)]})
        return processed

    def detect_video(self, video_path, mode: str = "default",
                     min_prob: float = 0.6, batch_size: int = 2,
                     show_progress: bool = True):
        frame_indices, frames, fps, video_length = \
            get_interest_frames_from_video(video_path)
        if mode == "fast":
            frames = [preprocess_image(f, min_side=480, max_side=800)
                      for f in frames]
        else:
            frames = [preprocess_image(f) for f in frames]
        scale = frames[0][1] if frames else 1.0
        frames = [f[0] for f in frames]
        all_results = {"metadata": {"fps": fps, "video_length": video_length,
                                    "video_path": video_path},
                       "preds": {}}
        while frames:
            batch, frames = frames[:batch_size], frames[batch_size:]
            batch_indices, frame_indices = (frame_indices[:batch_size],
                                            frame_indices[batch_size:])
            if not batch_indices:
                continue
            labels, scores, boxes = self._run(np.asarray(batch))
            boxes = boxes / scale
            for fi, fb, fs, fl in zip(batch_indices, boxes, scores, labels):
                preds = all_results["preds"].setdefault(fi, [])
                for box, score, label in zip(fb, fs, fl):
                    if score < min_prob:
                        continue
                    preds.append({"box": [int(c) for c in box.astype(int)],
                                  "score": float(score),
                                  "label": self.classes[int(label)]})
        return all_results

    def censor(self, img_path, out_path=None, visualize=False,
               parts_to_blur=()):
        """Black-box the detected parts (reference detector.py:165-191;
        visualize/imshow is intentionally not supported headless). Returns
        the censored image in BGR order, as cv2 holds it; writes a PNG."""
        if not out_path and not visualize:
            print("No out_path passed and visualize is set to false. "
                  "There is no point in running this function then.")
            return None
        image = np.ascontiguousarray(read_rgb(img_path)[:, :, ::-1])
        boxes = self.detect(img_path)
        if parts_to_blur:
            boxes = [i["box"] for i in boxes if i["label"] in parts_to_blur]
        else:
            boxes = [i["box"] for i in boxes]
        for box in boxes:
            _fill_box(image, box)
        if out_path:
            write_png(np.ascontiguousarray(image[:, :, ::-1]), out_path)
        return image
