"""Host-side image transforms (numpy) for fixed-shape batches.

A copy of ``deeplearning_tpu/data/transforms.py`` (numpy only), kept in the
port so it imports nothing of the JAX package; the same
``np.random.Generator`` gives the same outputs in both.

Covers the reference's transform stacks (SURVEY.md L3): classification
train/eval pipelines (RandomResizedCrop + flip + normalize,
classification/*/dataLoader), detection resize-with-pad
(fasterRcnn models/transform.py:70 GeneralizedRCNNTransform — here the
output is FIXED size, so every batch has one shape), color jitter
(yolov5 augment_hsv style). All pure numpy: runs in loader workers/host.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD
              ) -> np.ndarray:
    return (img.astype(np.float32) / 255.0 - mean) / std


def resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Simple numpy bilinear resize (no cv2 dependency needed, but uses
    cv2 when available for speed)."""
    try:
        import cv2
        return cv2.resize(img, (out_hw[1], out_hw[0]),
                          interpolation=cv2.INTER_LINEAR)
    except ImportError:
        h, w = img.shape[:2]
        oh, ow = out_hw
        ys = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
        xs = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        img = img.astype(np.float32)
        out = (img[y0][:, x0] * (1 - wy) * (1 - wx)
               + img[y0][:, x1] * (1 - wy) * wx
               + img[y1][:, x0] * wy * (1 - wx)
               + img[y1][:, x1] * wy * wx)
        return out


def resize_with_pad(img: np.ndarray, out_hw: Tuple[int, int],
                    boxes: Optional[np.ndarray] = None,
                    pad_value: float = 114.0):
    """Aspect-preserving resize + bottom/right pad to a FIXED size, with
    box rescaling — the GeneralizedRCNNTransform successor. Returns
    (padded_img, scale, boxes?)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    scale = min(oh / h, ow / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear(img, (nh, nw))
    out = np.full((oh, ow) + img.shape[2:], pad_value, np.float32)
    out[:nh, :nw] = resized
    if boxes is not None:
        boxes = np.asarray(boxes, np.float32) * scale
        return out, scale, boxes
    return out, scale


def random_flip_lr(img: np.ndarray, rng: np.random.Generator,
                   boxes: Optional[np.ndarray] = None, p: float = 0.5):
    if rng.uniform() >= p:
        return (img, boxes) if boxes is not None else img
    img = img[:, ::-1]
    if boxes is not None:
        w = img.shape[1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        return img, boxes
    return img


def random_resized_crop(img: np.ndarray, rng: np.random.Generator,
                        out_hw: Tuple[int, int],
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> np.ndarray:
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            y0 = rng.integers(0, h - ch + 1)
            x0 = rng.integers(0, w - cw + 1)
            crop = img[y0:y0 + ch, x0:x0 + cw]
            return resize_bilinear(crop, out_hw)
    return resize_bilinear(img, out_hw)   # fallback: full image


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4) -> np.ndarray:
    """Uint8-range jitter (applied before normalize)."""
    img = img.astype(np.float32)
    if brightness:
        img = img * rng.uniform(1 - brightness, 1 + brightness)
    if contrast:
        mean = img.mean()
        img = (img - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    if saturation:
        gray = img.mean(axis=-1, keepdims=True)
        img = gray + (img - gray) * rng.uniform(1 - saturation,
                                                1 + saturation)
    return np.clip(img, 0, 255)


def classification_train_transform(out_hw=(224, 224), seed: int = 0):
    """Batch-level wrapper over train_image_transform for
    DataLoader(transform=...)."""
    one = train_image_transform(out_hw, seed)

    def fn(batch: Dict) -> Dict:
        return {**batch, "image": np.stack([one(i)
                                            for i in batch["image"]])}
    return fn


_THREAD_SEED = itertools.count()


def thread_rng(local, seed: int) -> np.random.Generator:
    """Per-thread Generator for transforms running inside a worker pool
    (numpy Generators are not thread-safe). Each thread draws a unique
    counter value, so streams never collide — masked thread idents do
    (glibc reuses low address bits across pool threads)."""
    rng = getattr(local, "rng", None)
    if rng is None:
        rng = local.rng = np.random.default_rng(
            (seed, next(_THREAD_SEED)))
    return rng


def train_image_transform(out_hw=(224, 224), seed: int = 0):
    """Per-IMAGE augment closure for folder_source(transform=...) — runs
    inside the loader's decode worker pool."""
    import threading
    local = threading.local()

    def fn(img: np.ndarray) -> np.ndarray:
        rng = thread_rng(local, seed)
        img = random_resized_crop(img, rng, out_hw)
        img = random_flip_lr(img, rng)
        img = color_jitter(img, rng)
        return normalize(img)
    return fn


def light_image_transform(out_hw=(224, 224), seed: int = 0,
                          shift_frac: float = 0.1, flip: bool = False):
    """Per-IMAGE light augment: resize + random shift (pad-and-crop) —
    the small-image recipe (CIFAR/digits style) where ImageNet-strength
    RandomResizedCrop would destroy the object."""
    import threading
    local = threading.local()

    def fn(img: np.ndarray) -> np.ndarray:
        rng = thread_rng(local, seed)
        img = resize_bilinear(img, out_hw)
        ph = max(int(out_hw[0] * shift_frac), 1)
        pw = max(int(out_hw[1] * shift_frac), 1)
        img = np.pad(img, [(ph, ph), (pw, pw), (0, 0)], mode="edge")
        y0 = rng.integers(0, 2 * ph + 1)
        x0 = rng.integers(0, 2 * pw + 1)
        img = img[y0:y0 + out_hw[0], x0:x0 + out_hw[1]]
        if flip:
            img = random_flip_lr(img, rng)
        return normalize(img)
    return fn


def get_train_transform(preset: str, out_hw=(224, 224), seed: int = 0):
    """Augmentation preset registry for the classification pipeline:
    'imagenet' (RRC+flip+jitter), 'light' (resize+shift), 'none'."""
    if preset == "imagenet":
        return train_image_transform(out_hw, seed)
    if preset == "light":
        return light_image_transform(out_hw, seed)
    if preset == "none":
        return eval_image_transform(out_hw, crop_frac=1.0)
    raise ValueError(f"unknown augment preset {preset!r}")


def eval_image_transform(out_hw=(224, 224), crop_frac=0.875):
    """Per-IMAGE resize + center-crop + normalize closure."""
    def fn(img: np.ndarray) -> np.ndarray:
        rh, rw = int(out_hw[0] / crop_frac), int(out_hw[1] / crop_frac)
        img = resize_bilinear(img, (rh, rw))
        y0 = (rh - out_hw[0]) // 2
        x0 = (rw - out_hw[1]) // 2
        return normalize(img[y0:y0 + out_hw[0], x0:x0 + out_hw[1]])
    return fn


def classification_eval_transform(out_hw=(224, 224), crop_frac=0.875):
    """Batch-level wrapper over eval_image_transform."""
    one = eval_image_transform(out_hw, crop_frac)

    def fn(batch: Dict) -> Dict:
        return {**batch, "image": np.stack([one(i)
                                            for i in batch["image"]])}
    return fn
