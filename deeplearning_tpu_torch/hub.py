"""One-line model loading — the port of ``deeplearning_tpu/hub.py``.

    from deeplearning_tpu_torch import hub
    model, state = hub.load("vit_base_patch16_224", num_classes=1000,
                            seed=0)                  # on the card
    logits = model(images)                           # (B, 224, 224, 3)

    engine = hub.serve("vit_base_patch16_224", ckpt="runs/x/ckpt/best",
                       image_size=224, batch_buckets=(1, 8))
    probs = engine.infer(images)                     # warmed, on the card

``weights`` takes a flattened ``.npz`` of a JAX variable tree (see
``utils/convert.py``; a detector's ``batch_stats`` go into its BatchNorm
buffers), a flax tree, or a ``state_dict``; ``ckpt`` a checkpoint of the
port (a ``save_pytree`` directory or a ``CheckpointManager`` step),
restored by ``core.checkpoint.restore_variables`` (EMA weights first
unless ``prefer_ema=False``); without either the weights are initialised
from ``seed``. The model runs on ``cuda`` unless ``device`` says
otherwise, and raises when no card is visible.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .core.device import resolve_device

__all__ = ["load", "list_models", "model_kwargs", "serve"]


def list_models(filter: str = "") -> list:
    """Registry names, optionally substring-filtered."""
    from . import models  # noqa: F401  (registers the factories)
    from .core.registry import MODELS
    names = sorted(MODELS.keys())
    return [n for n in names if filter in n] if filter else names


# the families whose parameter shapes follow the input size (a position
# table, a Dense after a flatten, Swin's windows): their factories take
# ``img_size``, where flax infers the shapes at init
_SIZED = ("vit_", "mae_", "swin", "mnist_", "vgg", "googlenet",
          "transfg")


def model_kwargs(name: str, attn: str = "flash_hb",
                 size: Optional[int] = None) -> Dict[str, Any]:
    """The factory keywords behind a CLI's ``--attn`` and ``--size`` for
    registry model ``name``. A ViT and the MAE factories
    (``mae_vit_base_patch16``, ``mae_vit_small_patch16``, whose encoder and
    decoder blocks are ViT blocks) take ``attn_fn`` (``ops.attention``'s
    names). A Swin model takes ``use_pallas``: "naive" runs the unfused
    window attention, any flash name the fused window-attention kernel;
    "sdpa" raises. They, MAE, LeNet, VGG, GoogLeNet and TransFG take
    ``img_size`` when ``size`` is given. The other CNNs (CoAtNet and
    TransFG attend plainly, as in JAX) and the detectors take neither:
    their shapes do not follow the input size."""
    from .models.detection.predict import is_detection_model
    from .ops.attention import get_attn_fn, sdpa_adapter
    if is_detection_model(name):
        return {}
    fn = get_attn_fn(attn)
    kw: Dict[str, Any] = ({"img_size": int(size)}
                          if size is not None and name.startswith(_SIZED)
                          else {})
    if name.startswith(("vit_", "mae_")):
        kw["attn_fn"] = fn
    elif name.startswith("swin"):
        if fn is sdpa_adapter:
            raise ValueError(
                f"--attn {attn} is a ViT attention; a Swin model runs its "
                f"window attention fused ({attn!r} -> use 'flash' or "
                f"'flash_hb') or unfused ('naive')")
        kw["use_pallas"] = fn is not None
    return kw


def load(name: str, *, num_classes: int = 1000, weights: Any = None,
         ckpt: Optional[str] = None, prefer_ema: bool = True,
         seed: int = 0,
         device: Optional[Union[str, torch.device]] = None,
         **model_kw) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """Build a registry model (initialised from ``seed``), optionally load
    ``weights`` or restore ``ckpt``, move it to ``device`` once and put it
    in eval mode. Returns ``(module, state_dict)``; the state holds the
    BatchNorm buffers (running statistics) beside the parameters."""
    from . import models  # noqa: F401  (registers the factories)
    from .core.registry import MODELS
    from .utils.convert import as_state_dict

    if weights is not None and ckpt:
        raise ValueError("pass weights or ckpt, not both")
    dev = resolve_device(device)
    model = MODELS.build(name, num_classes=num_classes,
                         generator=torch.Generator().manual_seed(seed),
                         **model_kw)
    if weights is not None:
        model.load_state_dict(as_state_dict(weights, like=model))
    if ckpt:
        from .core.checkpoint import restore_variables
        model.load_state_dict(restore_variables(
            ckpt, model.state_dict(), prefer_ema=prefer_ema))
    model = model.to(dev).eval()
    return model, model.state_dict()


def serve(name: str, *, num_classes: int = 1000,
          ckpt: Optional[str] = None, image_size: int = 224,
          batch_buckets: Tuple[int, ...] = (1, 8, 32, 128),
          **engine_kw):
    """One-line serving session: a warmed ``serve.InferenceEngine`` (every
    bucket run once, nothing new built after this call). Wrap it in
    ``serve.MicroBatcher`` for concurrent requests."""
    from .serve import InferenceEngine
    return InferenceEngine(name, num_classes=num_classes, ckpt=ckpt,
                           image_size=image_size,
                           batch_buckets=batch_buckets, **engine_kw)
