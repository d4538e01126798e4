"""Path-based NudeNet classifier variants (the reference's non-PIL vendored
classifiers: nudenet/classifier.py:13-152, nudenet/lite_classifier.py:9-42,
nudenet/image_utils.py::load_images).

Counterpart of ``safe_denoiser_tpu/evals/nudenet_classifier.py`` on the
port's copy of the numpy ONNX interpreter (``evals/onnx_rt.py``). PNG
paths and arrays need neither PIL nor cv2:

* a PNG path is decoded by the port's own codec and resized with the index
  selection that picks PIL's NEAREST pixels (``data.images.read_png``,
  ``resize_nearest``); other formats (JPEG, ...) go through PIL, which must
  then be installed (``ImportError`` without it);
* an array input is a cv2 BGR frame (``classify_video`` feeds them) and is
  turned to RGB first, as upstream's ``image_utils.load_img`` does
  (``cv2.cvtColor(path, cv2.COLOR_BGR2RGB)``). The JAX package skips that
  step: on a frame the port equals JAX on ``frame[..., ::-1]``, the one
  intended difference between the two;
* ``classify_video`` reads the video with cv2 and raises ``ImportError``
  without it.

As in the JAX package, no auto-download (``pydload``): ``model_path`` is a
required constructor argument.
"""

from __future__ import annotations

import logging

import numpy as np

from ..data.images import read_rgb, resize_nearest
from .onnx_rt import InferenceSession


def _as_rgb(image) -> np.ndarray:
    """uint8 RGB [H, W, 3] of a path, a PIL image or a BGR(A) array."""
    if isinstance(image, np.ndarray):
        if image.ndim != 3 or image.shape[2] not in (3, 4):
            raise ValueError(f"a frame must be BGR or BGRA [H, W, 3|4], got "
                             f"{image.shape}")
        return np.ascontiguousarray(image[:, :, 2::-1])
    if hasattr(image, "convert"):                     # a PIL image
        return np.asarray(image.convert("RGB"))
    return read_rgb(image)


def load_images(image_paths, image_size, image_names=None):
    """reference image_utils.py::load_images: path/PIL/array list →
    ([N, H, W, 3] float32 batch, kept names); NEAREST resize to
    ``image_size``, RGB, /255. Per-image failures are logged and skipped,
    never raised; a missing package (PIL for a JPEG) raises."""
    if image_names is None:
        image_names = list(range(len(image_paths)))
    loaded, kept = [], []
    for path, name in zip(image_paths, image_names):
        try:
            img = _as_rgb(path)
            if img.shape[:2] != tuple(image_size):
                img = resize_nearest(img, (image_size[1], image_size[0]))
            loaded.append(img.astype(np.float32) / 255.0)
            kept.append(name)
        except ImportError:
            raise
        except Exception as ex:  # noqa: BLE001 — reference logs and skips
            logging.exception("Error reading %s %s", path, ex, exc_info=True)
    return np.asarray(loaded), kept


class Classifier:
    """reference nudenet/classifier.py::Classifier — batch classification
    over image *paths* (classify) and video files (classify_video)."""

    def __init__(self, model_path: str):
        self.nsfw_model = InferenceSession(model_path)

    def _predict(self, frames: np.ndarray, batch_size: int, categories):
        in_name = self.nsfw_model.get_inputs()[0].name
        out_name = self.nsfw_model.get_outputs()[0].name
        preds, probs = [], []
        for start in range(0, len(frames), batch_size):
            rows = self.nsfw_model.run(
                [out_name], {in_name: frames[start:start + batch_size]})[0]
            for row in rows:
                order = np.argsort(row).tolist()
                preds.append([categories[k] for k in order])
                probs.append([float(row[k]) for k in order])
        return preds, probs

    def classify(self, image_paths=(), batch_size: int = 4,
                 image_size=(256, 256), categories=("unsafe", "safe")):
        """{path: {category: prob}} over a path list (classifier.py:97-152)."""
        if not isinstance(image_paths, (list, tuple)):
            image_paths = [image_paths]
        frames, names = load_images(list(image_paths), image_size,
                                    image_names=list(image_paths))
        if not names:
            return {}
        preds, probs = self._predict(frames, batch_size, categories)
        out = {}
        for i, name in enumerate(names):
            if not isinstance(name, str):
                name = i
            out[name] = dict(zip(preds[i], probs[i]))
        return out

    def classify_video(self, video_path, batch_size: int = 4,
                       image_size=(256, 256),
                       categories=("unsafe", "safe")):
        """Frame-sampled video classification (classifier.py:39-95), using
        the same interest-frame selection as the ported detector (cv2)."""
        from .nudenet_detector import get_interest_frames_from_video

        frame_indices, frames, fps, video_length = \
            get_interest_frames_from_video(video_path)
        logging.debug(
            "VIDEO_PATH: %s, FPS: %s, Important frame indices: %s, "
            "Video length: %s", video_path, fps, frame_indices, video_length)
        frames, frame_names = load_images(frames, image_size,
                                          image_names=frame_indices)
        if not frame_names:
            return {}
        preds, probs = self._predict(frames, batch_size, categories)
        return {
            "metadata": {"fps": fps, "video_length": video_length,
                         "video_path": video_path},
            "preds": {name: dict(zip(preds[i], probs[i]))
                      for i, name in enumerate(frame_names)},
        }


class LiteClassifier:
    """reference nudenet/lite_classifier.py::LiteClassifier — the
    mobile-size model, fed NCHW (the reference's ``np.rollaxis(x, 3, 1)``
    before ``cv2.dnn`` forward). One image per forward, exactly like the
    reference's per-path loop."""

    def __init__(self, model_path: str):
        self.lite_model = InferenceSession(model_path)

    def classify(self, image_paths, size=(256, 256)):
        if isinstance(image_paths, str):
            image_paths = [image_paths]
        in_name = self.lite_model.get_inputs()[0].name
        out_name = self.lite_model.get_outputs()[0].name
        result = {}
        for image_path in image_paths:
            loaded, kept = load_images([image_path], size,
                                       image_names=[image_path])
            if not kept:
                continue
            batch = np.rollaxis(loaded, 3, 1)
            pred = self.lite_model.run([out_name], {in_name: batch})[0]
            result[image_path] = {"unsafe": float(pred[0][0]),
                                  "safe": float(pred[0][1])}
        return result
