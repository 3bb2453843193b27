"""Dataset discovery: class-folder scanning + train/val splitting — a
copy of ``deeplearning_tpu/data/datasets.py``.

Surface of the archetype-A loader stack (classification/mnist/dataLoader/
dataSet.py read_split_data and its ~16 copies): scan a root directory of
per-class subfolders, build (paths, labels), split train/val by ratio
with a fixed seed, and expose a MapSource that decodes+transforms on
access. Also the class_indices.json writer the predict CLIs consume.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .loader import MapSource

__all__ = ["IMG_EXTS", "read_split_data", "write_class_indices",
           "load_image", "folder_source"]

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".npy")


def read_split_data(root: str, val_rate: float = 0.2, seed: int = 0
                    ) -> Dict[str, object]:
    """Scan root/<class>/* images → shuffled train/val path+label splits
    and the class-index mapping (read_split_data surface)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    class_to_idx = {c: i for i, c in enumerate(classes)}
    paths: List[str] = []
    labels: List[int] = []
    for c in classes:
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(class_to_idx[c])
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(paths))
    n_val = int(len(paths) * val_rate)
    val_idx = set(order[:n_val].tolist())
    tr_p, tr_l, va_p, va_l = [], [], [], []
    for i, (p, l) in enumerate(zip(paths, labels)):
        if i in val_idx:
            va_p.append(p)
            va_l.append(l)
        else:
            tr_p.append(p)
            tr_l.append(l)
    return {"train_paths": tr_p, "train_labels": np.asarray(tr_l),
            "val_paths": va_p, "val_labels": np.asarray(va_l),
            "class_to_idx": class_to_idx}


def write_class_indices(class_to_idx: Dict[str, int], path: str) -> None:
    """class_indices.json (index -> name) for predict CLIs."""
    inv = {str(v): k for k, v in class_to_idx.items()}
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(inv, f, indent=2)


def load_image(path: str) -> np.ndarray:
    if path.lower().endswith(".npy"):
        return np.load(path)
    if path.lower().endswith((".jpg", ".jpeg")):
        # native libjpeg fast path (native/imagedec.cpp); decodes off the
        # GIL so loader threads overlap. Check availability BEFORE the
        # read so the fallback doesn't pay double file I/O.
        from .native_decode import available, decode_jpeg
        if available():
            with open(path, "rb") as f:
                data = f.read()
            img = decode_jpeg(data)
            if img is not None:
                return img.astype(np.float32)
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


def folder_source(paths: Sequence[str], labels: np.ndarray,
                  transform: Optional[Callable] = None) -> MapSource:
    """MapSource decoding images lazily from disk (the Dataset analog)."""
    labels = np.asarray(labels)

    def fetch(i: int) -> Dict[str, np.ndarray]:
        img = load_image(paths[i])
        if transform is not None:
            img = transform(img)
        return {"image": np.asarray(img, np.float32),
                "label": np.asarray(labels[i], np.int32)}

    return MapSource(len(paths), fetch)
