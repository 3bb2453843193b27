"""Keypoint (pose) data path: person-box affine crop + flip transforms —
the port's copy of ``deeplearning_tpu/data/keypoint_transforms.py`` (numpy
only, so it is copied as it is; the heatmap targets come from the port's
``evaluation/keypoints.make_heatmap_targets``).

Host-side numpy port of pose_estimation/Insulator/dataset/
coco_transforms.py: HalfBody (:232 — crop to upper/lower body subset),
AffineTransform (:276 — random scale/rotation warp of the person box to
a FIXED network input size), RandomHorizontalFlip (:344 — image flip +
left/right joint swap), affine_points (:56), flip_back (:18 — swap
channels of test-time flipped heatmaps), adjust_box (:157) and
scale_box (:179). The fixed output size keeps the model at one
static shape; heatmap target generation lives in
evaluation/keypoints.make_heatmap_targets.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# COCO 17-keypoint left/right pairs (matched_parts)
COCO_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))
COCO_UPPER_BODY = tuple(range(11))
COCO_LOWER_BODY = tuple(range(11, 17))


def adjust_box(xmin: float, ymin: float, w: float, h: float,
               fixed_size: Tuple[float, float]
               ) -> Tuple[float, float, float, float]:
    """Grow the box to the fixed h/w aspect ratio about its center
    (coco_transforms.py:157)."""
    xmax, ymax = xmin + w, ymin + h
    hw_ratio = fixed_size[0] / fixed_size[1]
    if h / max(w, 1e-6) > hw_ratio:
        wi = h / hw_ratio
        pad = (wi - w) / 2
        xmin, xmax = xmin - pad, xmax + pad
    else:
        hi = w * hw_ratio
        pad = (hi - h) / 2
        ymin, ymax = ymin - pad, ymax + pad
    return xmin, ymin, xmax - xmin, ymax - ymin


def scale_box(xmin: float, ymin: float, w: float, h: float,
              scale: Tuple[float, float]
              ) -> Tuple[float, float, float, float]:
    """Scale the box about its center (coco_transforms.py:179)."""
    s_h, s_w = h * scale[0], w * scale[1]
    return (xmin - (s_w - w) / 2, ymin - (s_h - h) / 2, s_w, s_h)


def half_body_box(keypoints: np.ndarray, visible: np.ndarray,
                  rng: np.random.Generator,
                  upper_ids: Sequence[int] = COCO_UPPER_BODY,
                  lower_ids: Sequence[int] = COCO_LOWER_BODY,
                  min_visible: int = 3
                  ) -> Optional[Tuple[float, float, float, float]]:
    """HalfBody augmentation (:232): box around the visible upper OR
    lower body joints, expanded 1.5×. None if too few are visible."""
    upper = [i for i in upper_ids if visible[i] > 0]
    lower = [i for i in lower_ids if visible[i] > 0]
    chosen = upper if (rng.random() < 0.5 and len(upper) > 2) else lower
    if len(chosen) <= min_visible - 1:
        chosen = upper if len(upper) > 2 else lower
    if len(chosen) <= min_visible - 1:
        return None
    pts = keypoints[chosen]
    xmin, ymin = pts.min(0)
    xmax, ymax = pts.max(0)
    w, h = xmax - xmin, ymax - ymin
    if w < 1 or h < 1:
        return None
    return scale_box(xmin, ymin, w, h, (1.5, 1.5))


def get_affine_matrix(box: Tuple[float, float, float, float],
                      out_hw: Tuple[int, int], rotation_deg: float = 0.0
                      ) -> np.ndarray:
    """2×3 matrix mapping src box coords → fixed out_hw crop, rotation
    about the box center (AffineTransform :276 semantics). The box must
    already have the output aspect ratio (adjust_box)."""
    xmin, ymin, w, h = box
    cx, cy = xmin + w / 2, ymin + h / 2
    oh, ow = out_hw
    theta = np.deg2rad(rotation_deg)
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    # translate(-center) → rotate → scale to out → translate(out center)
    sx, sy = ow / w, oh / h
    m = np.array([
        [sx * cos_t, -sx * sin_t, 0.0],
        [sy * sin_t, sy * cos_t, 0.0]], np.float64)
    m[:, 2] = [ow / 2 - m[0, 0] * cx - m[0, 1] * cy,
               oh / 2 - m[1, 0] * cx - m[1, 1] * cy]
    return m.astype(np.float32)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Inverse of a 2×3 affine (for mapping predictions back —
    get_final_preds/affine_points usage)."""
    full = np.vstack([m, [0, 0, 1]]).astype(np.float64)
    return np.linalg.inv(full)[:2].astype(np.float32)


def affine_points(pts: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Apply a 2×3 affine to (N, 2) points (coco_transforms.py:56)."""
    return pts @ m[:, :2].T + m[:, 2]


def warp_affine(img: np.ndarray, m: np.ndarray, out_hw: Tuple[int, int]
                ) -> np.ndarray:
    """Bilinear affine warp to a fixed output size. cv2 when available,
    pure-numpy inverse-mapping otherwise."""
    oh, ow = out_hw
    try:
        import cv2
        return cv2.warpAffine(img, m, (ow, oh),
                              flags=cv2.INTER_LINEAR)
    except ImportError:
        pass
    inv = invert_affine(m)
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    src = affine_points(
        np.stack([xs.ravel(), ys.ravel()], -1), inv)
    h, w = img.shape[:2]
    sx = np.clip(src[:, 0], 0, w - 1)
    sy = np.clip(src[:, 1], 0, h - 1)
    oob = ((src[:, 0] < -0.5) | (src[:, 0] > w - 0.5)
           | (src[:, 1] < -0.5) | (src[:, 1] > h - 0.5))
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    f = img.astype(np.float32).reshape(h * w, -1)
    idx = lambda yy, xx: f[yy * w + xx]  # noqa: E731
    out = (idx(y0, x0) * (1 - wy) * (1 - wx) + idx(y0, x1) * (1 - wy) * wx
           + idx(y1, x0) * wy * (1 - wx) + idx(y1, x1) * wy * wx)
    out[oob] = 0.0
    return out.reshape(oh, ow, -1 if img.ndim == 3 else 1).squeeze()


def flip_keypoints_lr(keypoints: np.ndarray, visible: np.ndarray,
                      width: float,
                      pairs: Sequence[Tuple[int, int]] = COCO_FLIP_PAIRS
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Mirror keypoints about the vertical axis and swap left/right
    joints (RandomHorizontalFlip :344)."""
    kps = keypoints.copy()
    vis = visible.copy()
    kps[:, 0] = width - 1 - kps[:, 0]
    for a, b in pairs:
        kps[[a, b]] = kps[[b, a]]
        vis[[a, b]] = vis[[b, a]]
    return kps, vis


def flip_back(heatmaps: np.ndarray,
              pairs: Sequence[Tuple[int, int]] = COCO_FLIP_PAIRS
              ) -> np.ndarray:
    """Un-flip test-time flipped heatmaps (H, W, K): mirror W and swap
    paired channels (coco_transforms.py:18)."""
    out = heatmaps[:, ::-1].copy()
    for a, b in pairs:
        out[..., [a, b]] = out[..., [b, a]]
    return out


def keypoint_train_transform(
        fixed_size: Tuple[int, int] = (256, 192),
        scale_range: Tuple[float, float] = (0.65, 1.35),
        rotation_range: Tuple[float, float] = (-45.0, 45.0),
        half_body_prob: float = 0.3,
        flip_prob: float = 0.5,
        heatmap_stride: int = 4,
        sigma: float = 2.0,
        seed: int = 0):
    """Full train-time pipeline for one (image, person box, keypoints)
    sample → dict with fixed-shape 'image' (H, W, 3), 'heatmaps'
    (H/s, W/s, K), 'kp_weights' (K,) — the Compose([HalfBody,
    AffineTransform, RandomHorizontalFlip, KeypointToHeatMap]) stack."""
    from ..evaluation.keypoints import make_heatmap_targets
    rng = np.random.default_rng(seed)

    def fn(image: np.ndarray, box, keypoints: np.ndarray,
           visible: np.ndarray) -> Dict[str, np.ndarray]:
        kps = np.asarray(keypoints, np.float32)
        vis = np.asarray(visible, np.float32)
        xmin, ymin, w, h = box
        if rng.random() < half_body_prob:
            hb = half_body_box(kps, vis, rng)
            if hb is not None:
                xmin, ymin, w, h = hb
        s = rng.uniform(*scale_range)
        xmin, ymin, w, h = scale_box(xmin, ymin, w, h, (s, s))
        xmin, ymin, w, h = adjust_box(xmin, ymin, w, h, fixed_size)
        rot = rng.uniform(*rotation_range)
        m = get_affine_matrix((xmin, ymin, w, h), fixed_size, rot)
        crop = warp_affine(image, m, fixed_size)
        kps_t = affine_points(kps, m)
        if rng.random() < flip_prob:
            crop = crop[:, ::-1].copy()
            kps_t, vis = flip_keypoints_lr(kps_t, vis, fixed_size[1])
        # joints warped outside the crop become invisible
        inside = ((kps_t[:, 0] >= 0) & (kps_t[:, 0] < fixed_size[1])
                  & (kps_t[:, 1] >= 0) & (kps_t[:, 1] < fixed_size[0]))
        vis = vis * inside
        heat_hw = (fixed_size[0] // heatmap_stride,
                   fixed_size[1] // heatmap_stride)
        heat = make_heatmap_targets(kps_t, vis, heat_hw,
                                    stride=heatmap_stride, sigma=sigma)
        return {"image": crop.astype(np.float32),
                "heatmaps": heat,
                "keypoints": kps_t,
                "kp_weights": (vis > 0).astype(np.float32),
                "affine": m}

    return fn
