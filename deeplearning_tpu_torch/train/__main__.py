"""Training CLI of the port — the counterpart of ``tools/train.py``.

  python -m deeplearning_tpu_torch.train --cfg configs/vit_b16_imagenet.yaml
  python -m deeplearning_tpu_torch.train model.name=vit_base_patch16_224 \\
      model.num_classes=1000 data.image_size=224 data.channels=3 \\
      data.global_batch=128 optim.name=adamw optim.lr=1e-3 train.epochs=2
  # on the CPU, a tiny model
  python -m deeplearning_tpu_torch.train train.device=cpu \\
      model.name=vit_micro_patch4_56 data.image_size=56 data.channels=3 \\
      data.n_train=16 data.global_batch=8 train.epochs=1
  # a class-folder dataset, with rollback, strict mode, async checkpoints
  python -m deeplearning_tpu_torch.train \\
      model.name=swin_tiny_patch4_window7_224 model.num_classes=8 \\
      data.folder=/data/imagefolder data.image_size=224 \\
      data.global_batch=128 train.recovery=rollback \\
      train.strict=transfers train.async_checkpoint=true \\
      train.workdir=runs/swin

The same ``Config`` sections and defaults as ``tools/train.py``, read the
same way (``--cfg`` YAML file, then dotted overrides). Data is the
synthetic set of ``load_data`` (the JAX CLI's, byte for byte), an
``.npz`` of ``images`` / ``labels`` with its validation split, or
(``data.folder``) a root of class folders read by
``data/build.build_classification_loaders`` (``data.num_workers`` decode
threads, ``data.augment`` imagenet | light | none, the class indices
written to ``train.workdir/class_indices.json``). The model comes from
the port's registry, initialised from ``train.seed``; ``model.attn``
picks the attention route as the serve CLI's ``--attn`` does (default
``flash_hb``, the hand-written K1 kernels). Batches go to ``train.device`` (default ``cuda``, which raises
without a card; the tests pass ``cpu``) through a ``DevicePrefetcher`` of
depth ``data.prefetch``; the Trainer logs, evaluates, checkpoints into
``train.workdir`` and resumes from it. ``train.recovery=rollback``,
``train.strict=transfers|nans`` and ``train.async_checkpoint=true`` are
the Trainer's ``recovery``, ``strict`` and ``async_checkpoint``. A run
preempted by SIGTERM / SIGINT checkpoints and exits 75 (requeue me).

Data parallel over ``torch.distributed``, as ``tools/train.py`` builds
its mesh: under torchrun (``WORLD_SIZE`` set), or with
``train.weight_update=zero1`` (the optimizer moments split over the
ranks) or ``train.grad_comm=int8`` (the EQuARX int8 gradient
collectives), the CLI starts the process group (NCCL on the card, gloo
with ``train.device=cpu``; a single process is a world of one), builds
the ``data=-1`` mesh, places the state with ``shard_state`` and trains
through ``make_train_step(mesh=...)``; each rank reads its slice of every
global batch and rank 0 logs and writes the checkpoints (with their
``topology.json``):

  torchrun --nproc_per_node=8 -m deeplearning_tpu_torch.train \
      --cfg configs/vit_b16_imagenet.yaml train.weight_update=zero1

Sequence, model and pipeline axes, as ``tools/train.py`` takes them
(the mesh is ``data=-1, model=train.pipeline_stages or
train.mesh_model_axis, seq=train.mesh_seq_axis`` and each rank reads
the rows of its data index):

- ``train.mesh_seq_axis=P train.seq_parallel=ring|ulysses`` builds the
  ViT with the ring or Ulysses ``attn_fn``. With ``model.attn`` a K1
  route (``flash``, ``flash_hb``) it is their flash path (K1's kernels;
  N must divide P), with ``model.attn=naive`` their masked plain path
  (``tools/train.py`` always builds the latter);
- ``train.mesh_model_axis=M`` gives the mesh a ``model`` axis and places
  the state without rules, as ``tools/train.py:268`` does: the model
  ranks hold replicated parameters and repeat one another's work (the
  tensor-parallel layout is ``make_train_step`` / ``shard_state`` with
  ``TRANSFORMER_TP_RULES``, which the JAX CLI does not pass either);
- ``train.pipeline_stages=S train.microbatches=M`` trains the ViT's
  blocks as S GPipe stages over M microbatches
  (``parallel.pipeline_train``); the Trainer checkpoints the whole
  stacked state.

  torchrun --nproc_per_node=2 -m deeplearning_tpu_torch.train \
      --cfg configs/vit_b16_imagenet.yaml train.mesh_seq_axis=2

Options of later slices raise naming the ROADMAP Queue 1 item that brings
them (``train.strict=threads`` / ``all`` item 8c); the port has no
``train.donate_batch`` (it updates the state in place).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str = "mnist_cnn"
    num_classes: int = 10
    precision: str = "bf16"          # bf16 | f32
    exact_gelu: bool = False         # erf GELU (torch.nn.GELU's)
    attn: str = "flash_hb"           # ops.attention's names, as --attn


@dataclasses.dataclass(frozen=True)
class DataCfg:
    folder: Optional[str] = None     # ImageFolder root
    npz: Optional[str] = None        # npz with images/labels arrays
    synthetic: bool = True
    image_size: int = 28
    channels: int = 1
    n_train: int = 512
    global_batch: int = 64
    val_rate: float = 0.2            # npz train/val split
    num_workers: int = 8             # folder-mode decode threads
    augment: str = "imagenet"        # folder-mode augmentation
    prefetch: int = 2                # device-feed queue depth (0 = off)


@dataclasses.dataclass(frozen=True)
class OptimCfg:
    name: str = "sgd"
    lr: float = 0.05
    weight_decay: float = 0.0
    momentum: float = 0.9
    schedule: str = "warmup_cosine"
    warmup_steps: int = 10
    clip_grad_norm: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    epochs: int = 3
    seed: int = 0
    label_smoothing: float = 0.0
    ema: bool = False
    workdir: Optional[str] = None
    device: str = "cuda"             # cuda | cpu
    mesh_model_axis: int = 1         # a 'model' axis (replicated)
    mesh_seq_axis: int = 1           # sequence parallelism over 'seq'
    seq_parallel: str = "ring"       # ring | ulysses
    accum_steps: int = 1             # gradient accumulation microbatches
    mixup: bool = False              # mixup/cutmix soft targets
    async_checkpoint: bool = False   # writes off the loop
    pipeline_stages: int = 1         # GPipe stages over 'model'
    microbatches: int = 0            # 0: pipeline_stages
    precompile: bool = True          # start the feed before the first step
    recovery: str = "none"           # none|abort|rollback
    strict: str = ""                 # transfers|nans (threads: item 8c)
    weight_update: str = "replicated"  # replicated | zero1: shard adam
    grad_comm: str = "fp32"          # fp32 | int8: EQuARX block-scaled


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    data: DataCfg = dataclasses.field(default_factory=DataCfg)
    optim: OptimCfg = dataclasses.field(default_factory=OptimCfg)
    train: TrainCfg = dataclasses.field(default_factory=TrainCfg)


def check_slice(cfg: Config) -> None:
    """Raise on an option whose mechanism comes with a later slice, and
    on ``tools/train.py``'s conflicts, with its messages, before any
    process group starts."""
    t = cfg.train
    pp = t.pipeline_stages
    if pp > 1 and (t.mesh_model_axis > 1 or t.mesh_seq_axis > 1):
        raise ValueError("train.pipeline_stages reuses the 'model' mesh "
                         "axis; unset mesh_model_axis/mesh_seq_axis")
    if pp > 1 and (t.mixup or t.ema or t.accum_steps > 1):
        raise ValueError("pipeline_stages does not compose with "
                         "mixup/ema/accum_steps yet")
    if (t.weight_update == "zero1" or t.grad_comm == "int8") and (
            pp > 1 or t.mesh_model_axis > 1 or t.mesh_seq_axis > 1):
        raise ValueError("train.weight_update=zero1 / train.grad_comm=int8 "
                         "are data-parallel modes; unset pipeline_stages/"
                         "mesh_model_axis/mesh_seq_axis")
    if t.seq_parallel not in ("ring", "ulysses"):
        raise ValueError(f"unknown train.seq_parallel={t.seq_parallel!r} "
                         "(ring | ulysses)")
    if pp > 1:
        micro = t.microbatches or pp
        if micro % pp:
            raise ValueError(
                f"train.microbatches={micro} must be divisible by "
                f"train.pipeline_stages={pp} (microbatch storage shards "
                "over the pipe axis)")
        if cfg.data.global_batch % micro:
            raise ValueError(
                f"data.global_batch={cfg.data.global_batch} must be "
                f"divisible by train.microbatches={micro}")
    if t.strict:
        from ..analysis import strict
        strict.resolve(t.strict)     # threads / all: item 8c
    if t.recovery not in ("none", "", "abort", "rollback"):
        raise ValueError(f"train.recovery={t.recovery!r} "
                         "(none | abort | rollback)")
    if t.weight_update not in ("replicated", "zero1"):
        raise ValueError(f"train.weight_update={t.weight_update!r} "
                         "(replicated | zero1)")
    if t.grad_comm not in ("fp32", "int8"):
        raise ValueError(f"train.grad_comm={t.grad_comm!r} (fp32 | int8)")
    if cfg.data.global_batch % max(t.accum_steps, 1):
        raise ValueError(
            f"data.global_batch={cfg.data.global_batch} must be divisible "
            f"by train.accum_steps={t.accum_steps}")
    if t.grad_comm == "int8" and t.accum_steps > 1:
        raise ValueError("train.grad_comm=int8 requires "
                         "train.accum_steps=1")


def uses_mesh(cfg: Config) -> bool:
    """True when the run trains on a mesh: under torchrun, over a group
    already running, with ZeRO-1 or the int8 collectives, or with a
    model or seq axis or pipeline stages."""
    import torch.distributed as dist
    return (cfg.train.weight_update != "replicated"
            or cfg.train.grad_comm != "fp32"
            or cfg.train.mesh_model_axis > 1
            or cfg.train.mesh_seq_axis > 1 or cfg.train.pipeline_stages > 1
            or "WORLD_SIZE" in os.environ or dist.is_initialized())


def load_data(cfg: DataCfg, num_classes: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``tools/train.py``'s data, byte for byte: the ``.npz``'s arrays as
    stored, or a seeded synthetic set whose class shows as a bright column
    stripe in channel 0."""
    if cfg.npz:
        blob = np.load(cfg.npz)
        return blob["images"], blob["labels"]
    rng = np.random.default_rng(0)
    n, s, c = cfg.n_train, cfg.image_size, cfg.channels
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    images = rng.normal(0, 0.1, (n, s, s, c)).astype(np.float32)
    block = max(s // num_classes, 1)
    for i, lab in enumerate(labels):
        images[i, :, lab * block:(lab + 1) * block, 0] += 2.0
    return images, labels


def classification_source(imgs: np.ndarray, labs: np.ndarray,
                          channels: int):
    """The dataset over stored arrays: per-sample uint8 -> float32 in
    [0, 1] and channel expansion, lazily, so the data stays in its
    compact dtype in RAM (``tools/train.py``'s ``_cls_source``)."""
    from ..data.loader import ArraySource, MapSource
    if not (imgs.dtype == np.uint8 or imgs.ndim == 3
            or imgs.shape[-1] != channels):
        return ArraySource(image=imgs, label=labs)

    def fetch(i):
        img = imgs[i]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1 and channels == 3:
            img = np.repeat(img, 3, axis=-1)
        return {"image": np.asarray(img, np.float32), "label": labs[i]}
    return MapSource(len(imgs), fetch)


def _split(cfg: Config, images, labels):
    """The npz validation split (before the schedule is sized), never
    smaller than one eval batch; the synthetic set evaluates on itself."""
    gb = cfg.data.global_batch
    if cfg.data.npz and cfg.data.val_rate > 0 and len(images) >= 2 * gb:
        order = np.random.default_rng(cfg.train.seed).permutation(
            len(images))
        n_val = min(max(int(len(images) * cfg.data.val_rate), gb),
                    len(images) - gb)
        return ((images[order[n_val:]], labels[order[n_val:]]),
                (images[order[:n_val]], labels[order[:n_val]]))
    return (images, labels), (images, labels)


def build(cfg: Config, **trainer_kw: Any):
    """The Trainer ``main`` runs, with its state, step, loaders and eval
    step built from ``cfg``; ``trainer_kw`` go to ``Trainer``."""
    from .. import hub, models  # noqa: F401  (registers the factories)
    from ..core import numerics
    from ..core import rng as rng_mod
    from ..core.config import asdict
    from ..core.device import resolve_device
    from ..core.registry import MODELS
    from ..data.loader import DataLoader
    from ..data.mixup import mixup_cutmix
    from .classification import make_loss_fn, make_metric_fn
    from .optim import build_optimizer
    from .schedules import build_schedule
    from .state import TrainState
    from .steps import make_eval_step, make_train_step
    from .trainer import Trainer

    check_slice(cfg)
    if cfg.model.name not in MODELS:
        raise ValueError(
            f"model.name={cfg.model.name!r} is not in the port yet (the "
            f"zoo_extra families, Xception to SENet-154, are ROADMAP Queue "
            f"1 item 8b); it has {', '.join(MODELS.keys())}")
    mesh = None
    if uses_mesh(cfg):
        from ..parallel.mesh import (MeshConfig, build_mesh,
                                     initialize_distributed)
        initialize_distributed(device=cfg.train.device)
        pp = cfg.train.pipeline_stages
        # the rank's card, whichever backend runs the group (gloo moves
        # CUDA tensors too, as two ranks on one card need)
        on_card = resolve_device(cfg.train.device).type == "cuda"
        mesh = build_mesh(MeshConfig(
            data=-1, model=pp if pp > 1 else cfg.train.mesh_model_axis,
            seq=cfg.train.mesh_seq_axis),
            device=(torch.device("cuda", torch.cuda.current_device())
                    if on_card else "cpu"))
        dev = mesh.device
    else:
        dev = resolve_device(cfg.train.device)
    gb = cfg.data.global_batch
    if cfg.data.folder:
        from ..data.build import LoaderConfig, build_classification_loaders
        lcfg = LoaderConfig(global_batch=gb, image_size=cfg.data.image_size,
                            val_rate=cfg.data.val_rate,
                            num_workers=cfg.data.num_workers,
                            seed=cfg.train.seed, augment=cfg.data.augment)
        loader, eval_loader, class_to_idx = build_classification_loaders(
            cfg.data.folder, lcfg, device=dev, mesh=mesh,
            class_indices_path=(os.path.join(cfg.train.workdir,
                                             "class_indices.json")
                                if cfg.train.workdir else None))
        if len(class_to_idx) != cfg.model.num_classes:
            raise ValueError(
                f"model.num_classes={cfg.model.num_classes} but "
                f"{cfg.data.folder} has {len(class_to_idx)} classes")
        size, channels, n_train = cfg.data.image_size, 3, len(loader) * gb
    else:
        images, labels = load_data(cfg.data, cfg.model.num_classes)
        (tr_images, tr_labels), (ev_images, ev_labels) = _split(
            cfg, images, labels)
        size, channels, n_train = (images.shape[1], cfg.data.channels,
                                   len(tr_images))
        loader = DataLoader(
            classification_source(tr_images, tr_labels, channels),
            global_batch=gb, seed=cfg.train.seed, device=dev, mesh=mesh)
        eval_loader = DataLoader(
            classification_source(ev_images, ev_labels, channels),
            global_batch=gb, shuffle=False, device=dev, mesh=mesh)
    numerics.set_exact(cfg.model.exact_gelu)
    model_kw = hub.model_kwargs(cfg.model.name, cfg.model.attn, size)
    if channels != 3:
        model_kw["in_chans"] = channels
    if cfg.train.mesh_seq_axis > 1:
        model_kw["attn_fn"] = _seq_attn_fn(cfg, mesh, model_kw)
    model = MODELS.build(
        cfg.model.name, num_classes=cfg.model.num_classes,
        dtype=torch.bfloat16 if cfg.model.precision == "bf16"
        else torch.float32,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        **model_kw)
    pp = cfg.train.pipeline_stages
    if pp > 1:
        from ..parallel.pipeline_train import vit_pipeline_module
        vit = model
        model, k_per_stage = vit_pipeline_module(vit, pp)
        vit.to("meta")       # a template only: the stages hold the weights
    model.to(dev)
    params = dict(model.named_parameters())
    steps_per_epoch = n_train // gb
    sched = build_schedule(cfg.optim.schedule, base_lr=cfg.optim.lr,
                           total_steps=cfg.train.epochs * steps_per_epoch,
                           warmup_steps=cfg.optim.warmup_steps)
    tx = build_optimizer(cfg.optim.name, sched,
                         clip_grad_norm=cfg.optim.clip_grad_norm or None,
                         weight_decay=cfg.optim.weight_decay,
                         momentum=cfg.optim.momentum, params=params)
    has_bn = any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                 for m in model.modules())
    state = TrainState.create(
        model=model, tx=tx,
        batch_stats=dict(model.named_buffers()) if has_bn else None,
        use_ema=cfg.train.ema)
    if pp > 1:
        from ..parallel.pipeline_train import (make_pipeline_train_step,
                                               shard_pipeline_state)
        shard_pipeline_state(state, mesh)
        base_step, eval_step = make_pipeline_train_step(
            vit, mesh, k_per_stage=k_per_stage,
            microbatches=cfg.train.microbatches or pp,
            label_smoothing=cfg.train.label_smoothing)
    else:
        if mesh is not None:
            from .steps import shard_state
            shard_state(state, mesh,
                        zero1=cfg.train.weight_update == "zero1")
        base_step = make_train_step(
            make_loss_fn(cfg.train.label_smoothing, has_bn),
            accum_steps=cfg.train.accum_steps, mesh=mesh,
            weight_update=cfg.train.weight_update,
            grad_comm=cfg.train.grad_comm,
            device=None if mesh is not None else dev)
        eval_step = (make_eval_step(make_metric_fn(), device=dev)
                     if mesh is None else
                     make_eval_step(make_metric_fn(), mesh=mesh))
    if cfg.train.mixup:
        def train_step(s, batch, rng):
            # the step's own augmentation stream, apart from its dropout
            gen = rng_mod.step_key(rng_mod.fold_in(rng, 1), s.step, dev)
            batch = mixup_cutmix(batch, gen, cfg.model.num_classes,
                                 smoothing=cfg.train.label_smoothing)
            return base_step(s, batch, rng)
    else:
        train_step = base_step
    kw = dict(state=state, train_step=train_step, train_loader=loader,
              eval_step=eval_step,
              eval_loader=eval_loader, epochs=cfg.train.epochs,
              seed=cfg.train.seed, workdir=cfg.train.workdir,
              log_every=max(steps_per_epoch // 2, 1),
              prefetch=cfg.data.prefetch, run_config=asdict(cfg),
              async_checkpoint=cfg.train.async_checkpoint,
              recovery=(None if cfg.train.recovery in ("none", "")
                        else cfg.train.recovery),
              strict=cfg.train.strict or None,
              weight_update=(cfg.train.weight_update if mesh is not None
                             else None))
    kw.update(trainer_kw)
    return Trainer(**kw)


def _seq_attn_fn(cfg: Config, mesh, model_kw):
    """The ring or Ulysses ``attn_fn`` over the mesh's ``seq`` axis: their
    flash path (K1) for a K1 route of ``model.attn``, their masked plain
    path for ``naive``."""
    from ..ops.attention import (flash_attn_adapter, flash_hb_adapter,
                                 get_attn_fn)
    fn = get_attn_fn(cfg.model.attn)
    if "attn_fn" not in model_kw:
        raise ValueError(f"train.mesh_seq_axis needs a transformer that "
                         f"takes attn_fn; {cfg.model.name} does not")
    if fn is not None and fn not in (flash_attn_adapter, flash_hb_adapter):
        raise ValueError(
            f"train.mesh_seq_axis runs the {cfg.train.seq_parallel} on K1 "
            f"(model.attn=flash | flash_hb) or on its plain path "
            f"(model.attn=naive), not model.attn={cfg.model.attn}")
    use_flash = fn is not None
    if cfg.train.seq_parallel == "ring":
        from ..parallel.ring_attention import make_ring_attn_fn
        return make_ring_attn_fn(mesh, use_flash=use_flash)
    from ..parallel.ulysses import make_ulysses_attn_fn
    return make_ulysses_attn_fn(mesh, use_flash=use_flash)


def main(argv=None) -> int:
    from ..core.config import config_cli
    cfg = config_cli(Config(), argv, description=__doc__.splitlines()[0])
    from ..elastic import EXIT_PREEMPTED, Preempted
    started = False
    if uses_mesh(cfg):
        from ..parallel.mesh import initialize_distributed
        check_slice(cfg)
        started = initialize_distributed(device=cfg.train.device)
    try:
        trainer = build(cfg)
        if cfg.train.precompile:
            trainer.precompile()       # the feed fills while nothing waits
        try:
            trainer.train()
        except Preempted:
            # the checkpoint and the flight ring are already flushed; 75
            # tells a supervisor "requeue me", not "I crashed"
            return EXIT_PREEMPTED
        results = trainer.evaluate()
        if trainer.is_main:
            print({k: round(v, 4) for k, v in results.items()})
        return 0
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
