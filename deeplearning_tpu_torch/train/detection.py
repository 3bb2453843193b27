"""Detection training CLI of the port — the counterpart of
``tools/train_detection.py``: train a detector, then score it with the
COCO evaluator.

  python -m deeplearning_tpu_torch.train.detection [--cfg FILE] [key=value]
  python -m deeplearning_tpu_torch.train.detection --exp yolox_s
  python -m deeplearning_tpu_torch.train.detection \\
      model.name=fasterrcnn_resnet50_fpn model.num_classes=20
  python -m deeplearning_tpu_torch.train.detection --evolve 10
  # on the CPU, tiny
  python -m deeplearning_tpu_torch.train.detection train.device=cpu \\
      model.name=yolox_nano model.image_size=64 data.batch=2 \\
      data.n_train=4 train.steps=2 train.multiscale=true

The same ``DetConfig`` sections and defaults as the JAX CLI, read the same
way (defaults < ``--exp`` < ``--cfg`` yaml < dotted overrides), plus
``train.device`` (default ``cuda``, which raises without a card; the tests
pass ``cpu``). Data is the synthetic coloured-box set (``synthetic_boxes``,
the JAX CLI's byte for byte), an ``.npz`` of images / boxes / labels /
valid, or a COCO ``instances.json`` (``data.coco``) split into train and
validation by ``data.val_rate``. ``data.mosaic`` makes every training
sample a 4-image mosaic (``data/mixup.mosaic_array_source``, or the COCO
source's mosaic mode over the training split), through
``random_perspective`` (``data.degrees`` / ``translate`` / ``scale`` /
``shear``) when ``data.random_perspective`` is set. The model comes from
the port's registry, initialised from ``train.seed`` (Faster R-CNN with
one more class, the background); its step is ``make_train_step`` over
the family's loss (``build_task``) with Adam, global-norm clipping and
optional frozen parameters, BatchNorm moving its statistics in train mode.
``train.multiscale`` resizes each batch on the device to the bucket of
``MultiScaleSchedule``; the last ``train.no_aug_steps`` steps draw from a
source without mosaic and perspective (the raw arrays, or the COCO
source with its flip only) and add YOLOX's L1 term (a second step
function: nothing else changes). ``--evolve N`` runs N generations of
``train/evolve.evolve`` over ``train.lr`` and ``train.clip_grad_norm``,
each a whole ``run`` scored by ``det_fitness``, its records appended to
``runs/evolve/detection.jsonl`` under the working directory. The
evaluation puts the model in eval mode and runs the family's batched
predict function (every NMS through ``ops/nms``: K3 on the card): over
the training arrays in one call, or over the COCO validation split in
padded chunks; the evaluator copies each batch to the host once and
prints the 12-metric summary. ``run`` is ``build``, ``train_steps`` and
``evaluate`` in turn; a caller that times or checks the steps drives
those three itself.

Families: RetinaNet, YOLOX, FCOS, YOLOv5 and Faster R-CNN, whose step
launches the proposals' NMS (K3 on the card) once over the batch between
its two forwards. ``train.eval_tta`` (YOLOX only; another family raises
before anything is built, as in JAX) scores the model a second time
through ``ops/tta.yolox_tta`` (three scales, the second flipped, one NMS
over every view's candidates) and adds that summary under ``"tta"``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["DetModelCfg", "DetDataCfg", "DetTrainCfg", "DetConfig",
           "DetRun", "synthetic_boxes", "build_task", "build", "train_steps",
           "evaluate", "tta_predict_fn", "run", "evolve_cfg", "main"]

EVAL_MAX_DET = 10
EVOLVE_RECORDS = "runs/evolve/detection.jsonl"


@dataclasses.dataclass(frozen=True)
class DetModelCfg:
    name: str = "retinanet_resnet18_fpn"
    num_classes: int = 3
    image_size: int = 128
    backbone_frozen_bn: bool = False  # frozen backbone BatchNorm statistics
    rcnn_post_nms_top_n: int = 256    # Faster R-CNN proposals after NMS
    rcnn_roi_batch: int = 128         # Faster R-CNN sampled RoIs an image
    nms_impl: str = "auto"            # ops/nms.py: auto | blocked | greedy


@dataclasses.dataclass(frozen=True)
class DetDataCfg:
    npz: Optional[str] = None
    coco: Optional[str] = None       # instances.json
    coco_images: Optional[str] = None  # default: <json dir>/images
    n_train: int = 32
    max_gt: int = 4
    batch: int = 8
    mosaic: bool = False             # a 4-image mosaic a sample
    random_perspective: bool = False  # yolov5's warp inside the mosaic
    degrees: float = 0.0             # hyp.scratch.yaml values
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    val_rate: float = 0.1            # COCO-mode eval split
    num_workers: int = 8             # COCO-mode decode threads
    prefetch: int = 2                # device-feed queue depth (0 = off)


@dataclasses.dataclass(frozen=True)
class DetTrainCfg:
    steps: int = 100
    lr: float = 1e-3
    clip_grad_norm: float = 1.0
    freeze: str = ""                  # comma-separated flax-path patterns
    seed: int = 0
    eval_score_thresh: float = 0.3
    eval_tta: bool = False            # YOLOX: a second, TTA evaluation
    multiscale: bool = False          # bucketed random resize
    multiscale_min: float = 0.75      # bucket range as ratios of image_size
    multiscale_max: float = 1.25
    multiscale_every: int = 10        # steps between size changes
    no_aug_steps: int = 0             # the last N steps: no mosaic or
                                      # perspective, YOLOX's L1 loss added
    device: str = "cuda"              # cpu: the tests' small runs


@dataclasses.dataclass(frozen=True)
class DetConfig:
    model: DetModelCfg = dataclasses.field(default_factory=DetModelCfg)
    data: DetDataCfg = dataclasses.field(default_factory=DetDataCfg)
    train: DetTrainCfg = dataclasses.field(default_factory=DetTrainCfg)


def synthetic_boxes(n: int, size: int, num_classes: int, max_gt: int,
                    seed: int = 0):
    """Images with 1-2 coloured squares; the class is the colour
    channel."""
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 0.05, (n, size, size, 3)).astype(np.float32)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    labels = np.zeros((n, max_gt), np.int64)
    valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        for g in range(rng.integers(1, 3)):
            w = rng.integers(size // 5, size // 2)
            h = rng.integers(size // 5, size // 2)
            x0 = rng.integers(0, size - w)
            y0 = rng.integers(0, size - h)
            cls = rng.integers(0, min(num_classes, 3))
            images[i, y0:y0 + h, x0:x0 + w, cls] += 1.5
            boxes[i, g] = (x0, y0, x0 + w, y0 + h)
            labels[i, g] = cls
            valid[i, g] = True
    return images, boxes, labels, valid


def _check_eval_tta(cfg) -> None:
    """``train.eval_tta`` of a family without TTA raises before anything
    is built."""
    if cfg.train.eval_tta and not cfg.model.name.startswith("yolox"):
        raise ValueError("train.eval_tta currently supports the YOLOX "
                         "family")


def build_task(model: torch.nn.Module, name: str, num_classes: int,
               score_thresh: float, max_det: int = 10,
               rcnn_kw: Optional[dict] = None,
               nms_impl: str = "auto") -> Tuple[Callable, Callable]:
    """Family dispatch. Returns (``loss_fn(params, state, batch, rng) ->
    (total, aux)`` for ``make_train_step``, YOLOX's with a keyword
    ``use_l1``; ``predict_fn(images) -> padded det dict``, the shared
    ``build_predict_fn``). The image size is read off the batch, so each
    multi-scale bucket gets its own anchors, grid or locations, cached on
    the batch's device. ``aux`` holds the BatchNorm buffers (updated in
    place by the train-mode forward) and the loss terms as device tensors.
    ``rcnn_kw``: Faster R-CNN's ``post_nms_top_n`` and ``roi_batch``
    (default ``DetModelCfg``'s); ``num_classes`` counts the foreground
    classes, Faster R-CNN's model carries the background besides."""
    from ..models.detection.predict import _cached, build_predict_fn
    rcnn_kw = rcnn_kw or {}
    post_nms = rcnn_kw.get("post_nms_top_n", DetModelCfg.rcnn_post_nms_top_n)
    roi_batch = rcnn_kw.get("roi_batch", DetModelCfg.rcnn_roi_batch)
    predict_fn = build_predict_fn(model, name, num_classes,
                                  score_thresh=score_thresh, max_det=max_det,
                                  post_nms_top_n=post_nms, nms_impl=nms_impl)

    def forward(params, state, images, **kw):
        state.model.train()
        return torch.func.functional_call(state.model, params, (images,),
                                          kw)

    def aux(state, terms: Dict[str, torch.Tensor]) -> dict:
        return {"batch_stats": dict(state.model.named_buffers()),
                "metrics": {k: v.detach() for k, v in terms.items()}}

    if name.startswith("retinanet"):
        from ..models.detection.retinanet import (retinanet_anchors,
                                                  retinanet_loss)
        anchors = _cached(retinanet_anchors)

        def loss_fn(params, state, batch, rng):
            images = batch["image"]
            hw = tuple(images.shape[1:3])
            out = forward(params, state, images)
            terms = retinanet_loss(out, anchors(hw, images.device),
                                   batch["boxes"], batch["labels"],
                                   batch["valid"])
            return terms["cls_loss"] + terms["reg_loss"], aux(state, terms)

        return loss_fn, predict_fn

    if name.startswith("yolox"):
        from ..models.detection.yolox import yolox_grid, yolox_loss
        grids = _cached(yolox_grid)

        def loss_fn(params, state, batch, rng, use_l1=False):
            images = batch["image"]
            centers, strides = grids(tuple(images.shape[1:3]), images.device)
            out = forward(params, state, images)
            terms = yolox_loss(out, centers, strides, batch["boxes"],
                               batch["labels"], batch["valid"],
                               num_classes=num_classes, use_l1=use_l1)
            total = (terms["iou_loss"] + terms["obj_loss"]
                     + terms["cls_loss"] + terms["l1_loss"])
            return total, aux(state, terms)

        return loss_fn, predict_fn

    if name.startswith("yolov5"):
        from ..models.detection.yolov5 import yolov5_grid, yolov5_loss
        grids = _cached(yolov5_grid)

        def loss_fn(params, state, batch, rng):
            images = batch["image"]
            grid = grids(tuple(images.shape[1:3]), images.device)
            out = forward(params, state, images)
            terms = yolov5_loss(out, grid, batch["boxes"], batch["labels"],
                                batch["valid"], num_classes=num_classes)
            total = terms["box_loss"] + terms["obj_loss"] + terms["cls_loss"]
            return total, aux(state, terms)

        return loss_fn, predict_fn

    if name.startswith("fcos"):
        from ..models.detection.fcos import (fcos_locations, fcos_loss,
                                             fcos_targets)
        locations = _cached(fcos_locations)

        def loss_fn(params, state, batch, rng):
            images = batch["image"]
            locs, lvl = locations(tuple(images.shape[1:3]), images.device)
            out = forward(params, state, images)
            terms = fcos_loss(out, fcos_targets(
                locs, lvl, batch["boxes"], batch["labels"], batch["valid"]))
            total = terms["cls_loss"] + terms["reg_loss"] + terms["ctr_loss"]
            return total, aux(state, terms)

        return loss_fn, predict_fn

    if name.startswith("fasterrcnn"):
        # two stages on one pyramid: the RPN loss on the first forward,
        # proposals (one NMS launch over the batch) and their sample, then
        # the RoI head on the same pyramid (no backbone recompute, no
        # BatchNorm). Gt labels shift +1: class 0 is the background.
        from ..models.detection.faster_rcnn import (
            fasterrcnn_anchors, generate_proposals, roi_head_loss, rpn_loss,
            sample_rois)
        anchors = _cached(fasterrcnn_anchors)

        def loss_fn(params, state, batch, rng):
            images, boxes, valid = (batch["image"], batch["boxes"],
                                    batch["valid"])
            hw = tuple(images.shape[1:3])
            a = anchors(hw, images.device)
            labels1 = torch.where(valid, batch["labels"] + 1, 0)
            out = forward(params, state, images)
            rpn = rpn_loss(out, a, boxes, valid, rng)
            # JAX stops the proposals' gradient: without autograd here the
            # NMS kernel and the sampler see plain tensors, and the RoI
            # head's gradient stops at its proposals just the same
            with torch.no_grad():
                props, pvalid = generate_proposals(
                    out, a, hw, post_nms_top_n=post_nms, nms_impl=nms_impl)
                samples = sample_rois(props, pvalid, boxes, labels1, valid,
                                      rng, batch_per_image=roi_batch)
            out2 = forward(params, state, images, proposals=samples["rois"],
                           pyramid=out["pyramid"])
            head = roi_head_loss(out2["roi_scores"], out2["roi_deltas"],
                                 samples)
            terms = {**rpn, **head}
            total = (rpn["rpn_obj_loss"] + rpn["rpn_reg_loss"]
                     + head["roi_cls_loss"] + head["roi_reg_loss"])
            return total, aux(state, terms)

        return loss_fn, predict_fn

    raise ValueError(f"no detection task for model {name!r} "
                     "(expected retinanet*/fasterrcnn*/yolox*/yolov5*/fcos*)")


def main(argv=None) -> int:
    """``[--exp NAME] [--cfg FILE] [key=value ...]``: the exp seeds the
    defaults (defaults < exp < yaml < CLI)."""
    from ..core.config import config_cli, load_config, pop_flag
    argv = list(sys.argv[1:] if argv is None else argv)
    evolve_gens = pop_flag(argv, "--evolve")
    exp_name = pop_flag(argv, "--exp")
    defaults = DetConfig()
    if exp_name:
        from ..core.experiment import get_exp
        defaults = load_config(
            defaults, None, get_exp(exp_name=exp_name).cli_overrides())
    cfg = config_cli(defaults, argv, description=__doc__)
    if evolve_gens:
        evolve_cfg(cfg, int(evolve_gens))
        return 0
    run(cfg)
    return 0


def evolve_cfg(cfg: DetConfig, generations: int) -> Dict[str, float]:
    """yolov5's ``--evolve``: each generation trains and scores a whole
    ``run`` with a mutated ``train.lr`` and ``train.clip_grad_norm`` (its
    fitness ``det_fitness`` of the COCO summary), appends the record to
    ``EVOLVE_RECORDS`` under the working directory and prints the best
    hyperparameters at the end."""
    from .evolve import DETECTION_META, det_fitness, evolve

    def eval_fn(hyp):
        trial = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, lr=hyp["lr"], clip_grad_norm=hyp["clip_grad_norm"]))
        return det_fitness(run(trial))

    meta = {"lr": DETECTION_META["lr"], "clip_grad_norm": (1.0, 0.1, 10.0)}
    best = evolve(eval_fn, {"lr": cfg.train.lr,
                            "clip_grad_norm": cfg.train.clip_grad_norm},
                  meta, generations, records_path=EVOLVE_RECORDS,
                  seed=cfg.train.seed)
    print(f"evolve done: best hyp {best}")
    return best


@dataclasses.dataclass
class DetRun:
    """One configuration built for training (``build``): the model and
    its train state, the step functions, the batch feed and what the
    evaluation scores."""
    cfg: DetConfig
    model: torch.nn.Module
    state: Any
    step: Callable
    step_l1: Optional[Callable]    # YOLOX: the step with the L1 term added
    predict_fn: Callable
    key: Any
    next_batch: Callable[[], dict]
    next_batch_plain: Callable[[], dict]  # the last no_aug_steps steps'
    schedule: Optional[Any]        # MultiScaleSchedule
    arrays: Optional[tuple]        # images, boxes, labels, valid (no COCO)
    val_src: Optional[Any]         # the COCO validation split
    feeds: list                    # iterators whose threads ``close`` stops

    def close(self) -> None:
        for feed in self.feeds:
            getattr(feed, "close", lambda: None)()


def build(cfg: DetConfig) -> DetRun:
    """Data, model (initialised from ``train.seed`` on ``train.device``),
    optimizer, step functions, multi-scale schedule and batch feed of one
    configuration."""
    from .. import models  # noqa: F401  (registers the factories)
    from ..core.device import resolve_device
    from ..core.registry import MODELS
    from ..core.rng import root_key
    from ..models.detection.predict import head_classes
    from .multiscale import MultiScaleSchedule
    from .optim import build_optimizer
    from .state import TrainState
    from .steps import make_train_step

    _check_eval_tta(cfg)
    if cfg.train.no_aug_steps >= max(cfg.train.steps, 1):
        raise ValueError(
            f"train.no_aug_steps={cfg.train.no_aug_steps} must be < "
            f"train.steps={cfg.train.steps} (it is the length of the "
            "FINAL aug-free phase)")
    dev = resolve_device(cfg.train.device)
    size = cfg.model.image_size
    num_classes = cfg.model.num_classes
    seed = cfg.train.seed
    arrays = train_src = val_src = plain_src = None
    persp = (dict(degrees=cfg.data.degrees, translate=cfg.data.translate,
                  scale=cfg.data.scale, shear=cfg.data.shear)
             if cfg.data.random_perspective else None)
    if cfg.data.coco:
        from ..data.coco import coco_detection_source, load_coco_json
        from ..data.loader import MapSource
        records, class_names = load_coco_json(cfg.data.coco)
        images_dir = cfg.data.coco_images or os.path.join(
            os.path.dirname(cfg.data.coco), "images")
        if cfg.model.num_classes != len(class_names):
            raise ValueError(
                f"model.num_classes={cfg.model.num_classes} but "
                f"{cfg.data.coco} has {len(class_names)} categories — "
                "set model.num_classes to match")
        order = np.random.default_rng(seed).permutation(len(records))
        n_val = max(int(len(records) * cfg.data.val_rate), 1)
        val_idx, tr_idx = order[:n_val], order[n_val:]
        kw = dict(images_dir=images_dir, records=records,
                  class_names=class_names, image_size=size,
                  max_gt=cfg.data.max_gt)
        # a mosaic's three extra tiles come from the training split only
        aug_src, _ = coco_detection_source(
            augment=True, seed=seed, mosaic=cfg.data.mosaic,
            perspective=persp, mosaic_pool=tr_idx, **kw)
        raw_src, _ = coco_detection_source(augment=False, **kw)
        train_src = MapSource(len(tr_idx),
                              lambda i: aug_src[int(tr_idx[i])])
        val_src = MapSource(len(val_idx),
                            lambda i: raw_src[int(val_idx[i])])
        if cfg.train.no_aug_steps > 0 and (cfg.data.mosaic
                                           or cfg.data.random_perspective):
            # close-mosaic: the flip stays, mosaic and perspective go
            plain_aug, _ = coco_detection_source(augment=True,
                                                 seed=seed + 1, **kw)
            plain_src = MapSource(len(tr_idx),
                                  lambda i: plain_aug[int(tr_idx[i])])
    elif cfg.data.npz:
        blob = np.load(cfg.data.npz)
        arrays = tuple(blob[k] for k in ("images", "boxes", "labels",
                                         "valid"))
    else:
        arrays = synthetic_boxes(cfg.data.n_train, size, num_classes,
                                 cfg.data.max_gt, seed)
    if cfg.data.mosaic and train_src is None:
        # the arrays' samples become fresh mosaics; float images fill with
        # the first image's median
        from ..data.mixup import mosaic_array_source
        train_src = mosaic_array_source(
            *arrays, out_size=size, max_boxes=cfg.data.max_gt, seed=seed,
            perspective=persp, fill=float(np.median(arrays[0][0])))

    model_kw = {}
    if cfg.model.backbone_frozen_bn:
        model_kw["backbone_frozen_bn"] = True
    model = MODELS.build(cfg.model.name,
                         num_classes=head_classes(cfg.model.name, num_classes),
                         generator=torch.Generator().manual_seed(seed),
                         **model_kw).to(dev)
    loss_fn, predict_fn = build_task(
        model, cfg.model.name, num_classes, cfg.train.eval_score_thresh,
        max_det=EVAL_MAX_DET,
        rcnn_kw=dict(post_nms_top_n=cfg.model.rcnn_post_nms_top_n,
                     roi_batch=cfg.model.rcnn_roi_batch),
        nms_impl=cfg.model.nms_impl)
    params = dict(model.named_parameters())
    tx = build_optimizer(
        "adam", cfg.train.lr, clip_grad_norm=cfg.train.clip_grad_norm,
        params=params,
        freeze=tuple(p.strip() for p in cfg.train.freeze.split(",")
                     if p.strip()) or None)
    state = TrainState.create(model=model, tx=tx,
                              batch_stats=dict(model.named_buffers()))
    step_l1 = (make_train_step(functools.partial(loss_fn, use_l1=True),
                               device=dev)
               if cfg.model.name.startswith("yolox") else None)

    schedule = None
    if cfg.train.multiscale:
        lo = int(size * cfg.train.multiscale_min) // 32 * 32
        hi = int(size * cfg.train.multiscale_max) // 32 * 32
        sizes = tuple(range(max(lo, 32), hi + 1, 32)) or (size,)
        schedule = MultiScaleSchedule(sizes=sizes,
                                      change_every=cfg.train.multiscale_every,
                                      seed=seed)

    feeds = []

    def loader_fn(src, loader_seed):
        from ..data.device_prefetch import DevicePrefetcher
        from ..data.loader import DataLoader
        loader = DataLoader(src, cfg.data.batch, shuffle=True,
                            seed=loader_seed, infinite=True, device=dev,
                            num_workers=cfg.data.num_workers)
        feeds.append(iter(DevicePrefetcher(loader, depth=cfg.data.prefetch)
                          if cfg.data.prefetch else loader))
        return functools.partial(next, feeds[-1])

    def array_fn():
        rng = np.random.default_rng(seed)
        n = len(arrays[0])

        def next_batch():
            idx = rng.choice(n, cfg.data.batch, replace=False)
            return {k: torch.from_numpy(a[idx]).to(dev) for k, a in
                    zip(("image", "boxes", "labels", "valid"), arrays)}
        return next_batch

    next_batch = (loader_fn(train_src, seed) if train_src is not None
                  else array_fn())
    next_batch_plain = next_batch
    if cfg.train.no_aug_steps > 0:
        if plain_src is not None:
            next_batch_plain = loader_fn(plain_src, seed + 1)
        elif train_src is not None and arrays is not None:
            next_batch_plain = array_fn()   # the raw arrays, no mosaic

    return DetRun(cfg=cfg, model=model, state=state,
                  step=make_train_step(loss_fn, device=dev), step_l1=step_l1,
                  predict_fn=predict_fn, key=root_key(seed),
                  next_batch=next_batch, next_batch_plain=next_batch_plain,
                  schedule=schedule, arrays=arrays, val_src=val_src,
                  feeds=feeds)


def train_steps(r: DetRun) -> Iterator[Tuple[int, dict, dict]]:
    """Run ``train.steps`` steps; yields ``(step, batch, metrics)`` once
    each step is dispatched (its metrics are device tensors; ``r.state``
    is the state after it). The last ``train.no_aug_steps`` steps draw
    from ``next_batch_plain`` and, for YOLOX, add the L1 term."""
    from .multiscale import resize_detection_batch
    cfg = r.cfg
    aug_close_at = (cfg.train.steps - cfg.train.no_aug_steps
                    if cfg.train.no_aug_steps > 0 else None)
    for it in range(cfg.train.steps):
        closing = aug_close_at is not None and it >= aug_close_at
        if closing and it == aug_close_at:
            print(f"step {it}: closing mosaic/perspective"
                  + (" + adding L1 loss" if r.step_l1 else ""))
        batch = (r.next_batch_plain if closing else r.next_batch)()
        if r.schedule is not None:
            batch = resize_detection_batch(batch,
                                           r.schedule.size_for_step(it))
        step = r.step_l1 if closing and r.step_l1 else r.step
        r.state, metrics = step(r.state, batch, r.key)
        yield it, batch, metrics


def tta_predict_fn(r: DetRun) -> Callable:
    """YOLOX's multi-scale + flip TTA predict over the run's model, at the
    evaluation's score threshold and slots."""
    from ..ops.tta import yolox_tta
    return functools.partial(yolox_tta, r.model,
                             score_thresh=r.cfg.train.eval_score_thresh,
                             max_det=EVAL_MAX_DET,
                             nms_impl=r.cfg.model.nms_impl)


def evaluate(r: DetRun, predict_fn: Optional[Callable] = None,
             tag: str = "") -> Tuple[Dict[str, float], Any, list]:
    """Score the model in eval mode with ``predict_fn`` (default the
    run's): the COCO validation split in padded chunks, else the training
    arrays in one call; each batch reaches the host once. Returns the
    summary, the evaluator and each predict call's detections; the
    printed summary starts with ``tag``."""
    from ..evaluation.coco_eval import CocoEvaluator
    predict_fn = predict_fn or r.predict_fn
    dev = next(r.model.parameters()).device
    r.model.eval()
    ev = CocoEvaluator(num_classes=r.cfg.model.num_classes)
    calls = []
    if r.val_src is not None:
        bs = r.cfg.data.batch
        n_val = len(r.val_src)
        for start in range(0, n_val, bs):
            # the tail chunk padded to the batch shape; only real images
            # are scored
            idx = np.minimum(np.arange(start, start + bs), n_val - 1)
            n_real = min(bs, n_val - start)
            sample = r.val_src[idx]
            det = predict_fn(torch.from_numpy(sample["image"]).to(dev))
            calls.append(det)
            ev.add_batch(np.arange(start, start + bs), det,
                         gt={"boxes": sample["boxes"],
                             "labels": sample["labels"],
                             "valid": sample["valid"]},
                         image_valid=np.arange(bs) < n_real)
    else:
        images, boxes, labels, valid = r.arrays
        det = predict_fn(torch.from_numpy(images).to(dev))
        calls.append(det)
        ev.add_batch(np.arange(len(images)), det,
                     gt={"boxes": boxes, "labels": labels, "valid": valid})
    summary = ev.summarize()
    print(tag + str({k: round(v, 4) for k, v in summary.items()}))
    return summary, ev, calls


def run(cfg: DetConfig) -> Dict[str, float]:
    """Train and evaluate one configuration; returns the COCO summary
    (with ``train.eval_tta``, the TTA summary under ``"tta"``)."""
    r = build(cfg)
    every = max(cfg.train.steps // 5, 1)
    try:
        for it, _, metrics in train_steps(r):
            if it % every == 0:
                print(f"step {it}: loss={float(metrics['loss']):.4f}")
    finally:
        r.close()               # stops a prefetcher's thread
    summary = evaluate(r)[0]
    if cfg.train.eval_tta:
        summary = {**summary,
                   "tta": evaluate(r, tta_predict_fn(r), tag="TTA ")[0]}
    return summary


if __name__ == "__main__":
    raise SystemExit(main())
