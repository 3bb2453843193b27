"""Torch checkpoint → the port's ``state_dict``: the port of
``deeplearning_tpu/utils/torch_import.py``.

The reference ships weight converters in both directions
(classification/efficientNet/trans_weights_to_pytorch.py,
deep_stereo/.../trans_weight_to_pytorch.py) plus a partial/renamed
state-dict loading tour (others/load_weights_test/load_weights.py). JAX's
module turns a torch ``state_dict`` into a flax variables tree, with the
layout transposes the two frameworks disagree on. The port is PyTorch, so
only the names move: OIHW conv kernels, (out, in) linear weights, norm
``weight`` / ``bias`` and BatchNorm ``running_mean`` / ``running_var``
keep their layouts and leaf names, ``num_batches_tracked`` is dropped (a
strict ``load_state_dict`` fills it in), and each module path goes
through ``rename`` and then the port's naming of flax module lists
(``blocks_0`` → ``blocks.0``, as ``utils/convert.from_flax_params`` maps
them). So ``torch_to_port(sd, rename)`` names what
``from_flax_params(torch_to_flax(sd, rename))`` names, for every leaf but
an ``nn.Embedding``'s, which JAX calls ``embedding`` and the port keeps
as ``weight``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from .convert import _module_name

__all__ = ["torch_to_port", "load_torch_checkpoint"]


def torch_to_port(
    state_dict: Mapping[str, Any],
    rename: Optional[Callable[[str], Optional[str]]] = None,
) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` under the port's names, as float32 tensors
    of the same layouts (copies).

    ``rename`` maps each module path (the key without its leaf, dots
    between parts) to the port's module path; return None to drop the
    entry. Parts named as flax module lists (``name_k``) become
    ``name.k``. Default: names unchanged."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        stem, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if rename is not None:
            stem = rename(stem)
            if stem is None:
                continue
        stem = ".".join(_module_name(p) for p in stem.split(".") if p)
        out[f"{stem}.{leaf}" if stem else leaf] = torch.as_tensor(
            value).detach().to("cpu", torch.float32).clone()
    return out


def load_torch_checkpoint(path: str, **kw) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` / ``.pt`` file (CPU map) and rename it. Takes a bare
    state_dict, a module, or the common {"model" | "state_dict" |
    "model_state_dict": ...} wrappers."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("model", "state_dict", "model_state_dict"):
        if isinstance(obj, dict) and wrapper in obj and isinstance(
                obj[wrapper], dict):
            obj = obj[wrapper]
            break
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return torch_to_port(obj, **kw)
