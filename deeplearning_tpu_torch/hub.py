"""One-line model loading — the port of ``deeplearning_tpu/hub.py``.

    from deeplearning_tpu_torch import hub
    model, state = hub.load("vit_base_patch16_224", num_classes=1000,
                            seed=0)                  # on the card
    logits = model(images)                           # (B, 224, 224, 3)

``weights`` takes a flattened ``.npz`` of a JAX variable tree (see
``utils/convert.py``; a detector's ``batch_stats`` go into its BatchNorm
buffers), a flax tree, or a ``state_dict``; without it the weights are
initialised from ``seed``. The model runs on ``cuda`` unless ``device``
says otherwise, and raises when no card is visible.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from .core.device import resolve_device

__all__ = ["load", "list_models", "model_kwargs"]


def list_models(filter: str = "") -> list:
    """Registry names, optionally substring-filtered."""
    from . import models  # noqa: F401  (registers the factories)
    from .core.registry import MODELS
    names = sorted(MODELS.keys())
    return [n for n in names if filter in n] if filter else names


def model_kwargs(name: str, attn: str = "flash_hb",
                 size: Optional[int] = None) -> Dict[str, Any]:
    """The factory keywords behind a CLI's ``--attn`` and ``--size`` for
    registry model ``name``. A ViT takes ``attn_fn`` (``ops.attention``'s
    names). A Swin model takes ``use_pallas``: "naive" runs the unfused
    window attention, any flash name the fused window-attention kernel;
    "sdpa" raises. Both take ``img_size`` when ``size`` is given. A
    detector takes neither: it has no attention and reads its input size
    off the batch."""
    from .models.detection.predict import is_detection_model
    from .ops.attention import get_attn_fn, sdpa_adapter
    if is_detection_model(name):
        return {}
    fn = get_attn_fn(attn)
    kw: Dict[str, Any] = {} if size is None else {"img_size": int(size)}
    if name.startswith("vit_"):
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
         seed: int = 0,
         device: Optional[Union[str, torch.device]] = None,
         **model_kw) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """Build a registry model (initialised from ``seed``), optionally load
    ``weights``, move it to ``device`` once and put it in eval mode.
    Returns ``(module, state_dict)``; the state holds the BatchNorm
    buffers (running statistics) beside the parameters."""
    from . import models  # noqa: F401  (registers the factories)
    from .core.registry import MODELS
    from .utils.convert import as_state_dict

    dev = resolve_device(device)
    model = MODELS.build(name, num_classes=num_classes,
                         generator=torch.Generator().manual_seed(seed),
                         **model_kw)
    if weights is not None:
        model.load_state_dict(as_state_dict(weights, like=model))
    model = model.to(dev).eval()
    return model, model.state_dict()
