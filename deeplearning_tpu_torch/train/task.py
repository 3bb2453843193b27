"""Task CLI of the port for the non-classification families — the
counterpart of ``tools/train_task.py``.

  python -m deeplearning_tpu_torch.train.task --task segmentation \\
      model.name=unet
  python -m deeplearning_tpu_torch.train.task --task mae train.steps=20
  python -m deeplearning_tpu_torch.train.task --task supcon
  python -m deeplearning_tpu_torch.train.task --task metric
  python -m deeplearning_tpu_torch.train.task --task keypoints
  python -m deeplearning_tpu_torch.train.task --task stereo
  python -m deeplearning_tpu_torch.train.task --task stereo_online
  # on the CPU
  python -m deeplearning_tpu_torch.train.task --task mae train.device=cpu

The same tasks, config tree (``model``, ``data``, ``train``), defaults,
synthetic data (numpy from ``train.seed``, the JAX CLI's byte for byte),
``data.npz`` paths and ``task_metric …`` lines as the JAX CLI. Each task
trains its model with Adam (the port's ``scale_by_adam`` and
``scale_by_learning_rate``, as ``optax.adam``) from weights initialised
from seed 0, with the model in eval mode as JAX's ``train=False`` runs it
(BatchNorm on its running statistics, no dropout); MAE trains in train
mode, its mask noise drawn from the step's generator (``core/rng
.step_key`` of key 5 and the step, as JAX folds the step into key 5).
``stereo_online`` is MAD online adaptation: every frame the sampler
picks two of MADNet's top-level blocks, and both the gradients and the
Adam updates of the others are masked to 0.

Beside JAX's options: ``train.device`` (default ``cuda``, which raises
without a card; the tests pass ``cpu``) and ``model.attn`` (default
``flash_hb``), which reaches MAE's encoder and decoder blocks through
``hub.model_kwargs``: ``flash_hb`` and ``flash`` run every attention
through K1 on the card (its plain version on the CPU), ``naive`` the
model's own softmax attention.

``build(task, cfg)`` gives a ``TaskRun`` (the model, ``loss(i)`` for step
i, and the closing evaluation), ``run`` trains it and returns the losses;
``build`` takes ``weights`` (a state dict or a flax tree to start from)
and, for MAE,
``mask_noise`` (step → (B, N) noise), which the parity tests use.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.rng import root_key, step_key
from ..utils.convert import as_state_dict
from .optim import adam, apply_updates

__all__ = ["ModelCfg", "DataCfg", "TrainCfg", "TaskConfig", "DEFAULT_MODEL",
           "TaskRun", "build", "run", "RUNNERS", "main"]


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str = ""                   # per-task default if empty
    num_classes: int = 4
    image_size: int = 32
    attn: str = "flash_hb"           # MAE's: flash_hb | flash | naive


@dataclasses.dataclass(frozen=True)
class DataCfg:
    npz: Optional[str] = None
    n_train: int = 32
    batch: int = 8


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    steps: int = 30
    lr: float = 1e-3
    seed: int = 0
    device: str = "cuda"             # cpu: the tests' small runs


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    data: DataCfg = dataclasses.field(default_factory=DataCfg)
    train: TrainCfg = dataclasses.field(default_factory=TrainCfg)


DEFAULT_MODEL = {
    "segmentation": "unet",
    "mae": "mae_vit_small_patch16",
    "supcon": "supcon_resnet18",
    "metric": "arcface_resnet18",
    "keypoints": "hrnet_w18_keypoints",
    "stereo": "madnet",
    "stereo_online": "madnet",
}
# the key JAX's MAE task folds each step into for its mask noise
MAE_MASK_KEY = 5


@dataclasses.dataclass
class TaskRun:
    """A built task: ``loss(i)`` is step i's loss (a scalar tensor),
    ``report()`` evaluates the trained model and prints its
    ``task_metric`` line; ``online`` marks MAD online adaptation."""
    model: torch.nn.Module
    loss: Callable[[int], torch.Tensor]
    report: Callable[[], None]
    online: bool = False


# ------------------------------------------------------------- helpers
def _load_npz_images(blob) -> np.ndarray:
    """images from an npz: uint8 -> [0, 1] float, grayscale -> RGB."""
    images = blob["images"]
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    if images.ndim == 3:
        images = np.repeat(images[..., None], 3, axis=-1)
    return images


def _make_batcher(batch: int, *arrays: torch.Tensor):
    """Deterministic wraparound minibatches over equally indexed arrays:
    step i's batch starts at (i · b) mod (n − b + 1)."""
    b = min(batch, arrays[0].shape[0])

    def batch_at(i):
        start = (i * b) % (arrays[0].shape[0] - b + 1)
        return tuple(a[start:start + b] for a in arrays)
    return batch_at


def _chunked_apply(n_total: int, batch: int):
    """(idx, n_real) chunks over [0, n_total) at a fixed batch: a tail
    chunk repeats the last index and only its first n_real rows count."""
    eb = min(batch, n_total)
    for start in range(0, n_total, eb):
        idx = np.minimum(np.arange(start, start + eb), n_total - 1)
        yield idx, min(eb, n_total - start)


def _pk_order(labels_all: np.ndarray) -> np.ndarray:
    """Two instances of an id adjacent, ids cycling: every wraparound
    batch has positives and negatives."""
    by_id = np.argsort(labels_all, kind="stable")
    within = np.zeros(len(labels_all), np.int64)
    counts: Dict[int, int] = {}
    for pos, idx in enumerate(by_id):
        c = int(labels_all[idx])
        within[pos] = counts.get(c, 0)
        counts[c] = counts.get(c, 0) + 1
    return by_id[np.lexsort((within % 2, labels_all[by_id],
                             within // 2))]


def _model(cfg: TaskConfig, task: str, dev: torch.device,
           weights: Optional[Dict[str, torch.Tensor]], **kw):
    """The registry model, float32, initialised from seed 0 (JAX's
    ``jax.random.key(0)``) or loaded with ``weights`` (a state dict, a
    flax tree or an ``.npz``; parameters without ``batch_stats`` keep the
    BatchNorm statistics at flax's init, mean 0 and variance 1), on
    ``dev``."""
    from .. import models  # noqa: F401  (registers the factories)
    from ..core.registry import MODELS
    model = MODELS.build(cfg.model.name or DEFAULT_MODEL[task],
                         dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0), **kw)
    if weights is not None:
        sd = as_state_dict(weights, like=model)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        stats = ("running_mean", "running_var", "num_batches_tracked")
        bad = unexpected + [k for k in missing if not k.endswith(stats)]
        if bad:
            raise KeyError(f"weights do not fit {type(model).__name__}: "
                           f"{bad[:8]}")
    return model.to(dev)


def _tensor(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


# --------------------------------------------------------------- tasks
def _segmentation(cfg, dev, weights, **_):
    from ..evaluation.metrics import confusion_matrix, miou_from_confusion
    from ..ops import losses as L

    if cfg.data.npz:
        # npz with images (N, H, W, 3) and masks (N, H, W) int; the first
        # 10% held out for the mIoU report
        blob = np.load(cfg.data.npz)
        images = _load_npz_images(blob)
        masks = blob["masks"].astype(np.int32)
        num_classes = int(masks.max()) + 1
        n_val = max(len(images) // 10, 1)
        val_x, val_y = images[:n_val], masks[:n_val]
        batch_at = _make_batcher(cfg.data.batch,
                                 _tensor(images[n_val:], dev),
                                 _tensor(masks[n_val:], dev).long())
    else:
        s = cfg.model.image_size
        rng = np.random.default_rng(cfg.train.seed)
        x = rng.normal(0, 0.1, (cfg.data.batch, s, s, 3)).astype(
            np.float32)
        y = np.zeros((cfg.data.batch, s, s), np.int32)
        for i in range(cfg.data.batch):
            cx, cy, r = rng.integers(8, s - 8), rng.integers(8, s - 8), 6
            yy, xx = np.mgrid[:s, :s]
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            y[i][m] = 1
            x[i][m] += 1.0
        tr = (_tensor(x, dev), _tensor(y, dev).long())
        val_x, val_y = x, y
        num_classes = 2
        batch_at = lambda i: tr  # noqa: E731

    model = _model(cfg, "segmentation", dev, weights,
                   num_classes=num_classes).eval()

    def logits_of(bx):
        out = model(bx)
        return out[0] if isinstance(out, tuple) else out

    def loss(i):
        bx, by = batch_at(i)
        logits = logits_of(bx)
        return L.cross_entropy(logits, by) + L.dice_loss(logits, by)

    @torch.no_grad()
    def report():
        mat = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                          device=dev)
        for idx, n_real in _chunked_apply(len(val_x), cfg.data.batch):
            pred = logits_of(_tensor(val_x[idx], dev)).argmax(-1)
            mat += confusion_matrix(pred[:n_real],
                                    _tensor(val_y[idx][:n_real], dev),
                                    num_classes)
        miou = miou_from_confusion(mat)["miou"]
        print(f"task_metric miou={float(miou):.4f}")
    return TaskRun(model, loss, report)


def _mae(cfg, dev, weights, mask_noise=None):
    from ..hub import model_kwargs

    if cfg.data.npz:
        images = _load_npz_images(np.load(cfg.data.npz))
        batch_at = _make_batcher(cfg.data.batch, _tensor(images, dev))
        hw = images.shape[1:3]
    else:
        s = max(cfg.model.image_size, 32)
        tr_x = _tensor(np.random.default_rng(cfg.train.seed).normal(
            size=(cfg.data.batch, s, s, 3)).astype(np.float32), dev)
        batch_at = lambda i: (tr_x,)  # noqa: E731
        hw = (s, s)
    name = cfg.model.name or DEFAULT_MODEL["mae"]
    kw = model_kwargs(name, cfg.model.attn)
    model = _model(cfg, "mae", dev, weights, depth=2, decoder_depth=2,
                   img_size=tuple(int(v) for v in hw), **kw).train()
    last = {}

    def loss(i):
        (bx,) = batch_at(i)
        noise = None if mask_noise is None else mask_noise(i)
        out, _, _ = model(bx, rng=step_key(root_key(MAE_MASK_KEY), i, dev),
                          mask_noise=noise)
        last["loss"] = out.detach()
        return out

    def report():
        print(f"task_metric mae_recon_loss={float(last['loss']):.4f}"
              if last else "task_metric mae_recon_loss=nan")
    return TaskRun(model, loss, report)


def _supcon(cfg, dev, weights, **_):
    from ..ops import losses as L

    rng = np.random.default_rng(cfg.train.seed)
    if cfg.data.npz:
        # npz {images, labels}; the second view is a horizontal flip
        blob = np.load(cfg.data.npz)
        images = _load_npz_images(blob)
        labels_all = blob["labels"].astype(np.int32)
        order = _pk_order(labels_all)
        batch_at = _make_batcher(cfg.data.batch, _tensor(images[order], dev),
                                 _tensor(labels_all[order], dev))
        two_views = lambda bx: (bx, bx.flip(2))  # noqa: E731
    else:
        s = cfg.model.image_size
        labels = np.repeat(np.arange(max(cfg.data.batch // 2, 1)), 2)
        base = rng.normal(0, 0.2, (len(labels), s, s, 3)).astype(np.float32)
        base[np.arange(len(labels)), labels * 3 % s,
             labels * 3 % s, :] += 2.0
        tr = (_tensor(base, dev), _tensor(labels, dev))
        batch_at = lambda i: tr  # noqa: E731
        two_views = lambda bx: (bx, bx)  # noqa: E731

    model = _model(cfg, "supcon", dev, weights,
                   num_classes=cfg.model.num_classes).eval()
    last = {}

    def loss(i):
        bx, by = batch_at(i)
        va, vb = two_views(bx)
        feats = torch.stack([model(va), model(vb)], dim=1)
        out = L.supcon_loss(feats, by)
        last["loss"] = out.detach()
        return out

    def report():
        print(f"task_metric supcon_loss={float(last.get('loss', np.nan)):.4f}")
    return TaskRun(model, loss, report)


def _metric(cfg, dev, weights, **_):
    from ..evaluation.retrieval import cmc_map, pairwise_distances
    from ..ops import losses as L

    s = cfg.model.image_size
    rng = np.random.default_rng(cfg.train.seed)
    if cfg.data.npz:
        # npz with images (N, H, W[, 3]) and identity labels (N,)
        blob = np.load(cfg.data.npz)
        images = _load_npz_images(blob)
        labels_all = blob["labels"].astype(np.int32)
        order = _pk_order(labels_all)
        x, y = images[order], labels_all[order]
        n_id = int(y.max()) + 1
        batch_at = _make_batcher(cfg.data.batch, _tensor(x, dev),
                                 _tensor(y, dev))
    else:
        n_id = cfg.model.num_classes
        y = np.repeat(np.arange(n_id), max(cfg.data.batch // n_id, 2))
        x = rng.normal(0, 0.2, (len(y), s, s, 3)).astype(np.float32)
        for i, lab in enumerate(y):
            x[i, :, lab * 4 % s:(lab * 4 % s) + 3, :] += 1.5
        tr = (_tensor(x, dev), _tensor(y, dev))
        batch_at = lambda i: tr  # noqa: E731

    model = _model(cfg, "metric", dev, weights, num_classes=n_id).eval()

    def loss(i):
        bx, by = batch_at(i)
        out = model(bx)
        emb = out["embedding"]
        logits = L.arcface_logits(emb, out["centers"], by)
        return L.cross_entropy(logits, by) + L.triplet_loss(emb, by,
                                                            margin=0.3)

    @torch.no_grad()
    def report():
        chunks = [model(_tensor(x[idx], dev))["embedding"][:n_real].cpu()
                  .numpy() for idx, n_real in _chunked_apply(
                      len(x), cfg.data.batch)]
        emb = np.concatenate(chunks)
        # query / gallery interleaved: every query id is in the gallery
        res = cmc_map(pairwise_distances(emb[0::2], emb[1::2]),
                      np.asarray(y)[0::2], np.asarray(y)[1::2])
        print(f"task_metric rank1={res['rank1']:.4f} mAP={res['mAP']:.4f}")
    return TaskRun(model, loss, report)


def _keypoints(cfg, dev, weights, **_):
    from ..evaluation.keypoints import (decode_heatmaps,
                                        make_heatmap_targets, pck)
    from ..ops import losses as L

    if cfg.data.npz:
        # npz with images (N, H, W[, 3]) and keypoints (N, K, 3) = (x, y,
        # vis); targets for the training slice only
        blob = np.load(cfg.data.npz)
        images = _load_npz_images(blob)
        kps_all = blob["keypoints"].astype(np.float32)
        h, w = images.shape[1:3]
        s = max(h, w)
        k = kps_all.shape[1]
        vis_all = kps_all[..., 2]
        n_val = max(len(images) // 10, 1)
        val = (images[:n_val], kps_all[:n_val], vis_all[:n_val])
        targets = np.stack([
            make_heatmap_targets(kps_all[i, :, :2], vis_all[i],
                                 (h // 4, w // 4), stride=4)
            for i in range(n_val, len(images))])
        batch_at = _make_batcher(cfg.data.batch,
                                 _tensor(images[n_val:], dev),
                                 _tensor(targets, dev),
                                 _tensor(vis_all[n_val:], dev))
    else:
        s = max(cfg.model.image_size, 64)
        k = 4
        rng = np.random.default_rng(cfg.train.seed)
        kps = rng.uniform(8, s - 8,
                          (cfg.data.batch, k, 2)).astype(np.float32)
        vis = np.ones((cfg.data.batch, k), np.float32)
        x = np.zeros((cfg.data.batch, s, s, 3), np.float32)
        for i in range(cfg.data.batch):
            for j in range(k):
                xx, yy = int(kps[i, j, 0]), int(kps[i, j, 1])
                x[i, max(yy - 1, 0):yy + 2,
                  max(xx - 1, 0):xx + 2, j % 3] = 2.0
        target = np.stack([
            make_heatmap_targets(kps[i], vis[i], (s // 4, s // 4), stride=4)
            for i in range(cfg.data.batch)])
        tr = (_tensor(x, dev), _tensor(target, dev), _tensor(vis, dev))
        batch_at = lambda i: tr  # noqa: E731
        val = (x, np.concatenate([kps, vis[..., None]], -1), vis)

    model = _model(cfg, "keypoints", dev, weights, num_classes=k).eval()

    def loss(i):
        bx, bt, bv = batch_at(i)
        return L.heatmap_mse_loss(model(bx), bt, bv)

    @torch.no_grad()
    def report():
        val_x, val_kp, val_vis = val
        scores = []
        for idx, n_real in _chunked_apply(len(val_x), cfg.data.batch):
            pred = decode_heatmaps(model(_tensor(val_x[idx], dev)),
                                   stride=4)[0].cpu().numpy()
            scores.extend(pck(pred[i], val_kp[idx[i], :, :2],
                              val_vis[idx[i]], threshold_px=s * 0.2)
                          for i in range(n_real))
        print(f"task_metric pck@0.2={float(np.mean(scores)):.4f}")
    return TaskRun(model, loss, report)


def _stereo_frames(cfg, dev):
    """(the pair every stereo step takes, frame_at(i) -> the online
    step's pair): the npz's whole set and its frame i mod N, or one
    synthetic pair (the right image the left one shifted 3 pixels)."""
    if cfg.data.npz:
        blob = np.load(cfg.data.npz)
        lefts = _tensor(_load_npz_images({"images": blob["left"]}), dev)
        rights = _tensor(_load_npz_images({"images": blob["right"]}), dev)
        return (lefts, rights), lambda i: (lefts[i % lefts.shape[0]][None],
                                           rights[i % rights.shape[0]][None])
    rng = np.random.default_rng(cfg.train.seed)
    s = max(cfg.model.image_size, 64)
    left = rng.normal(0, 1, (max(cfg.data.batch, 1), s, s, 3)).astype(
        np.float32)
    pair = (_tensor(left, dev), _tensor(np.roll(left, -3, axis=2), dev))
    return pair, lambda i: pair


def _stereo(cfg, dev, weights, **_):
    from ..models.stereo.madnet import photometric_loss
    (left, right), _ = _stereo_frames(cfg, dev)
    model = _model(cfg, "stereo", dev, weights).eval()
    last = {}

    def loss(i):
        out = photometric_loss(left, right, model(left, right)["disparity"])
        last["loss"] = out.detach()
        return out

    def report():
        print(f"task_metric photometric="
              f"{float(last.get('loss', np.nan)):.4f}")
    return TaskRun(model, loss, report)


def _stereo_online(cfg, dev, weights, **_):
    from ..models.stereo.madnet import photometric_loss
    _, frame_at = _stereo_frames(cfg, dev)
    model = _model(cfg, "stereo_online", dev, weights).eval()
    last = {}

    def loss(i):
        left, right = frame_at(i)
        out = photometric_loss(left, right, model(left, right)["disparity"])
        last["loss"] = out.detach()
        return out

    def report():
        print(f"task_metric photometric_online="
              f"{float(last.get('loss', np.nan)):.4f}")
    return TaskRun(model, loss, report, online=True)


RUNNERS = {
    "segmentation": _segmentation,
    "mae": _mae,
    "supcon": _supcon,
    "metric": _metric,
    "keypoints": _keypoints,
    "stereo": _stereo,
    "stereo_online": _stereo_online,
}


def build(task: str, cfg: TaskConfig,
          weights: Optional[Dict[str, torch.Tensor]] = None,
          mask_noise: Optional[Callable[[int], torch.Tensor]] = None
          ) -> TaskRun:
    """The task's model, data and loss on ``cfg.train.device``."""
    if task not in RUNNERS:
        raise SystemExit(f"--task must be one of {list(RUNNERS)}")
    dev = resolve_device(cfg.train.device)
    return RUNNERS[task](cfg, dev, weights, mask_noise=mask_noise)


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach (an unused
    head) gets zeros, as JAX's gradient has them."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


def run(task: str, cfg: TaskConfig, weights=None,
        mask_noise=None) -> List[float]:
    """Train ``task`` for ``cfg.train.steps`` Adam steps, print the
    progress and the task metric; returns every step's loss."""
    r = build(task, cfg, weights, mask_noise)
    params = dict(r.model.named_parameters())
    tx = adam(cfg.train.lr)
    opt = tx.init(params)
    steps = cfg.train.steps
    sampler = None
    if r.online:
        from ..models.stereo.madnet import MADSampler
        sampler = MADSampler(r.model.block_names(), sample_n=2,
                             mode="probabilistic", seed=cfg.train.seed)
    losses: List[float] = []
    for i in range(steps):
        if sampler is not None:
            selected = sampler.sample()
            mask = sampler.grad_mask(params, selected)
        loss = r.loss(i)
        grads = _grads(loss, params)
        if sampler is not None:
            grads = {n: g * mask[n] for n, g in grads.items()}
        updates, opt = tx.update(grads, opt, params)
        if sampler is not None:
            # the update too: Adam's momentum would keep moving the
            # deselected blocks for many frames
            updates = {n: u * mask[n] for n, u in updates.items()}
        apply_updates(params, updates)
        losses.append(float(loss.detach()))
        if sampler is not None:
            sampler.update(selected, losses[-1])
        if i % max(steps // 5, 1) == 0:
            print(f"frame {i}: loss={losses[-1]:.4f} blocks={selected}"
                  if sampler is not None
                  else f"step {i}: loss={losses[-1]:.4f}", flush=True)
    if losses:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("no steps run")
    r.report()
    return losses


def main(argv=None) -> int:
    from ..core.config import config_cli, pop_flag

    argv = list(sys.argv[1:] if argv is None else argv)
    task = pop_flag(argv, "--task")
    if task not in RUNNERS:
        raise SystemExit(f"--task must be one of {list(RUNNERS)}")
    cfg = config_cli(TaskConfig(), argv, description=__doc__)
    losses = run(task, cfg)
    return 0 if losses and np.isfinite(losses[-1]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
