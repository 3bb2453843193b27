"""Feature-map / kernel / prediction visualization — the port of
``deeplearning_tpu/utils/visualize.py`` (numpy, so a copy).

Surface of others/visual_weight_feature_map_test
(visual_feature_map.py:66 truncated-model per-channel plots,
visual_kernel_weight.py:23 conv-kernel grids), tensorboard_test's figure
helpers, and the detection demo drawing (yolov5 utils/plots.py). Pure
numpy → (H, W, 3) uint8 images that feed TensorBoardWriter.add_image or
PIL. ``kernel_grid`` keeps JAX's (kh, kw, cin, cout) layout: pass a port
conv weight (cout, cin, kh, kw) as ``w.permute(2, 3, 1, 0)``.

Difference from the JAX module, by decision: ``capture_feature_maps``
takes a port module (its weights inside) and records every submodule's
output with forward hooks, where JAX's applies a flax module with
``capture_intermediates``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _to_grid(tiles: np.ndarray, pad: int = 1) -> np.ndarray:
    """(N, H, W) → one (rows·H, cols·W) grid image, normalized per tile."""
    n, h, w = tiles.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    canvas = np.zeros((rows * (h + pad), cols * (w + pad)), np.float32)
    for i in range(n):
        t = tiles[i]
        lo, hi = t.min(), t.max()
        t = (t - lo) / (hi - lo + 1e-9)
        r, c = divmod(i, cols)
        canvas[r * (h + pad):r * (h + pad) + h,
               c * (w + pad):c * (w + pad) + w] = t
    return canvas


def feature_map_grid(features: np.ndarray, max_channels: int = 64
                     ) -> np.ndarray:
    """(H, W, C) activation → uint8 grid of the first C channels."""
    f = np.asarray(features, np.float32)
    f = np.moveaxis(f, -1, 0)[:max_channels]
    return (255 * _to_grid(f)).astype(np.uint8)


def kernel_grid(kernel: np.ndarray, max_kernels: int = 64) -> np.ndarray:
    """(kh, kw, cin, cout) conv kernel → uint8 grid (input-channel mean)."""
    k = np.asarray(kernel, np.float32).mean(axis=2)     # (kh, kw, cout)
    k = np.moveaxis(k, -1, 0)[:max_kernels]
    return (255 * _to_grid(k, pad=1)).astype(np.uint8)


def capture_feature_maps(model, x, filter_fn=None
                         ) -> Dict[str, np.ndarray]:
    """Run the port module ``model`` in eval mode on ``x`` (no gradients)
    and return the output of every submodule whose forward runs, by its
    qualified name ("" is the model's own), the first element of a tuple
    output, as float32 numpy (the truncated-model forward of
    visual_feature_map.py, through forward hooks; a layer a model applies
    functionally records nothing). ``filter_fn(name, module)`` picks the
    modules to record; the model's train / eval mode is restored after."""
    import torch
    flat: Dict[str, np.ndarray] = {}

    def hook(name):
        def record(_module, _inputs, out):
            arr = out[0] if isinstance(out, tuple) else out
            if isinstance(arr, torch.Tensor):
                flat[name] = arr.detach().float().cpu().numpy()
        return record
    handles = [m.register_forward_hook(hook(name))
               for name, m in model.named_modules()
               if filter_fn is None or filter_fn(name, m)]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train(was)
        for h in handles:
            h.remove()
    return flat


def draw_boxes(image: np.ndarray, boxes: np.ndarray,
               labels: Optional[Sequence] = None,
               scores: Optional[np.ndarray] = None,
               color: Tuple[int, int, int] = (0, 255, 0),
               thickness: int = 2) -> np.ndarray:
    """Draw xyxy boxes on a uint8 image (detection demo rendering)."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8).copy())
    for i, box in enumerate(np.asarray(boxes)):
        x1, y1, x2, y2 = (int(round(float(v))) for v in box)
        x1, x2 = np.clip([x1, x2], 0, img.shape[1] - 1)
        y1, y2 = np.clip([y1, y2], 0, img.shape[0] - 1)
        img[y1:y1 + thickness, x1:x2] = color
        img[max(y2 - thickness, 0):y2, x1:x2] = color
        img[y1:y2, x1:x1 + thickness] = color
        img[y1:y2, max(x2 - thickness, 0):x2] = color
    return img


def confusion_matrix_figure(matrix: np.ndarray,
                            class_names: Sequence[str]):
    """matplotlib figure of a confusion matrix (tensorboard_test
    add_figure tour); returns None when matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(matrix, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names, rotation=45)
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    for i in range(len(class_names)):
        for j in range(len(class_names)):
            ax.text(j, i, f"{matrix[i, j]:.0f}", ha="center", va="center")
    fig.tight_layout()
    return fig


def pr_curve_figure(curves):
    """Overlay per-class PR curves (yolov5 utils/metrics.py plot_pr_curve
    surface). ``curves``: {name: {"precision", "recall", "ap"}} as
    produced by evaluation.metrics.precision_recall_curve. Returns a
    matplotlib figure or None."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(6, 6))
    for name, c in curves.items():
        ax.plot(c["recall"], c["precision"],
                label=f"{name} AP={c['ap']:.3f}")
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.legend(loc="lower left", fontsize=8)
    fig.tight_layout()
    return fig


def embedding_projection_figure(embeddings: np.ndarray,
                                labels: Sequence[int],
                                method: str = "pca"):
    """2-D scatter of embeddings colored by label — the SupCon t-SNE.py
    visualization surface. method: "pca" (no extra deps) or "tsne"
    (sklearn, falling back to PCA if unavailable). Returns a matplotlib
    figure or None."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    x = np.asarray(embeddings, np.float64)
    proj = None
    if method == "tsne" and len(x) >= 5:
        try:
            from sklearn.manifold import TSNE
            proj = TSNE(n_components=2, init="pca",
                        perplexity=min(30.0, max(2.0, len(x) / 4 - 1))
                        ).fit_transform(x)
        except (ImportError, ValueError):   # no sklearn / tiny n_samples
            proj = None
    if method == "tsne" and proj is None:
        method = "pca"
    if proj is None:
        x = x - x.mean(0)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        proj = x @ vt[:2].T
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(proj[:, 0], proj[:, 1], c=np.asarray(labels),
                    cmap="tab10", s=12)
    fig.colorbar(sc, ax=ax, label="class")
    ax.set_title(f"embedding projection ({method.upper()})")
    fig.tight_layout()
    return fig
