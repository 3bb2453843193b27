"""flax parameter tree → the port's ``state_dict``: the reverse of
``deeplearning_tpu/utils/torch_import.py``.

Rules, per leaf of a tree of numpy arrays (flax names → port names):
- module path ``blocks_0/attn/qkv`` → ``blocks.0.attn.qkv``;
- Dense ``kernel`` (in, out) → ``weight`` (out, in);
- a 4-D HWIO ``kernel`` (kh, kw, cin, cout): → ``weight`` (cout, cin, kh,
  kw) where the target (``like``) holds a 4-D weight, a ``Conv2d``;
  otherwise it is the patch ``proj/kernel`` (p, p, c, embed) → ``weight``
  (embed, p·p·c), the order PatchEmbed flattens patches in;
  a depthwise or grouped kernel (kh, kw, cin / groups, cout) takes the
  same transpose, to the (cout, cin / groups, kh, kw) of its grouped
  ``Conv2d``;
  a dilated kernel (ASPP's) the same transpose (the dilation lives in
  the module, not the weight); MAE's conv ``patch_embed`` kernel (p, p,
  c, embed) goes to its 2-D linear ``weight`` (embed, p·p·c), as a patch
  ``proj``; U-Net's ``ConvTranspose`` kernel is kept as a ``Conv2d``
  weight (OIHW) and run flipped by the module;
- LayerNorm / BatchNorm ``scale`` → ``weight`` (HRNet's ``ConvBN`` and
  the FCN's ``aux_head`` are plain conv + BatchNorm pairs); ``bias``,
  ``cls_token``, ``pos_embed``, MAE's ``enc_pos`` / ``dec_pos`` (1, N, d)
  and ``mask_token`` (1, 1, d), ArcFace's ``arcface_centers`` (D, C),
  ConvNeXt's layer-scale ``gamma`` and the MoE experts'
  batched ``fc1_kernel`` (E, d, h) / ``fc2_kernel`` / biases keep their
  names and shapes (the port's ``ExpertMlp`` keeps JAX's layout, so
  ``MOE_RULES`` split their dim 0 as JAX's do);
- the ``batch_stats`` collection, beside ``params``: BatchNorm ``mean`` →
  ``running_mean``, ``var`` → ``running_var`` (also the 1-D BatchNorms
  over embeddings of BDB and ArcFace, which the port runs as 2-D ones).
  The port's ``num_batches_tracked`` has no flax counterpart; a strict
  ``load_state_dict`` fills it in by itself;
- a module list named as flax names ``name_k`` (HRNet's
  ``down{j}to{i}_{k}``) is ``name.k``.

``load_npz`` reads a flattened ``.npz`` of such a tree (keys joined by
``/``, with or without the leading ``params``; a ``batch_stats/...`` key
carries the statistics). ``flax_path`` maps a port name back to its flax
path (what the optimizer masks are judged on), and ``from_optax_state``
carries an optax optimizer state across.

The other way round, ``variable_names`` lists the tensors of a module
that are leaves of its flax variable tree (parameters and BatchNorm
statistics, not the port's own constant buffers), and ``to_flax_order`` /
``from_flax_order`` view one of them in its flax element order (a kernel
transposed back) and return: what the serving engine's int8 residency cuts
its blocks over.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["from_flax_params", "load_npz",
           "as_state_dict", "flax_path", "from_optax_state",
           "variable_names", "to_flax_order", "from_flax_order"]

_INDEXED = re.compile(r"(.+)_(\d+)")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _module_name(part: str) -> str:
    m = _INDEXED.fullmatch(part)
    return f"{m.group(1)}.{m.group(2)}" if m else part


_STATS = {"mean": "running_mean", "var": "running_var"}


def _target_ndims(like: Any) -> Dict[str, int]:
    if like is None:
        return {}
    if isinstance(like, torch.nn.Module):
        like = like.state_dict()
    return {k: len(v.shape) for k, v in like.items()}


def from_flax_params(params: Mapping, like: Any = None
                     ) -> Dict[str, torch.Tensor]:
    """Map a flax param tree (optionally wrapped in ``{"params": ...}``,
    with ``batch_stats`` beside it) of numpy-convertible arrays to a
    ``state_dict`` of float32 tensors. ``like`` (the target module or its
    ``state_dict``) tells a conv kernel from a patch projection."""
    stats: Mapping = {}
    if isinstance(params.get("params"), Mapping):
        stats = params.get("batch_stats") or {}
        params = params["params"]
    ndims = _target_ndims(like)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        arr = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        stem = ".".join(_module_name(m) for m in mods)
        key = f"{stem}.weight" if stem else "weight"
        if leaf == "kernel":
            if arr.ndim == 4 and ndims.get(key) == 4:     # Conv2d: HWIO→OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 4:               # HWIO conv-shaped projection
                arr = arr.reshape(-1, arr.shape[-1]).T
            elif arr.ndim == 2:
                arr = arr.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        key = f"{stem}.{leaf}" if stem else leaf
        out[key] = torch.from_numpy(np.array(arr, order="C"))  # own copy
    for path, value in _leaves(stats):
        *mods, leaf = path
        stem = ".".join(_module_name(m) for m in mods)
        out[f"{stem}.{_STATS.get(leaf, leaf)}"] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C"))
    return out


def flax_path(name: str, ndim: int) -> str:
    """The flax path of port parameter ``name`` with ``ndim`` dims:
    ``blocks.0.attn.qkv.weight`` (2-D) -> ``blocks_0/attn/qkv/kernel``;
    a 1-D ``weight`` is a LayerNorm / BatchNorm ``scale``; a BatchNorm
    ``running_mean`` / ``running_var`` is its ``batch_stats`` ``mean`` /
    ``var``."""
    *mods, leaf = name.split(".")
    parts: list = []
    for m in mods:
        if m.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{m}"
        else:
            parts.append(m)
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    leaf = {v: k for k, v in _STATS.items()}.get(leaf, leaf)
    return "/".join(parts + [leaf])


def variable_names(module: torch.nn.Module) -> list:
    """The ``state_dict`` names of ``module`` that are leaves of its flax
    variable tree: every parameter and the BatchNorm ``running_mean`` /
    ``running_var``. The port's own buffers (relative-position indices,
    shift masks, ``num_batches_tracked``) have no flax leaf."""
    buffers = {n for n, _ in module.named_buffers()
               if n.rsplit(".", 1)[-1] in _STATS.values()}
    params = {n for n, _ in module.named_parameters()}
    return [n for n in module.state_dict() if n in params or n in buffers]


def to_flax_order(name: str, t: torch.Tensor) -> torch.Tensor:
    """A view of port tensor ``name`` whose row-major element order is its
    flax leaf's: a 2-D ``weight`` (Dense ``(out, in)``, or a patch
    projection) transposed back to ``(in, out)``, a 4-D conv ``weight``
    OIHW back to HWIO; any other tensor as it is."""
    if name.rsplit(".", 1)[-1] == "weight":
        if t.dim() == 2:
            return t.t()
        if t.dim() == 4:
            return t.permute(2, 3, 1, 0)
    return t


def from_flax_order(name: str, flat: torch.Tensor,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    """The inverse of ``to_flax_order``: a view, of port shape ``shape``,
    of the elements of ``flat`` laid out in flax order."""
    if name.rsplit(".", 1)[-1] == "weight":
        if len(shape) == 2:
            return flat.view(shape[1], shape[0]).t()
        if len(shape) == 4:
            o, i, h, w = shape
            return flat.view(h, w, i, o).permute(3, 2, 0, 1)
    return flat.view(shape)


def from_optax_state(state: Any) -> Any:
    """An optax optimizer state (numpy leaves) as the port's optimizer
    state (``train/optim.py``): each optax state namedtuple becomes a dict
    of its fields, a chain's tuple stays a tuple, a parameter-shaped tree
    (Adam's ``mu``/``nu``, SGD's ``trace``) goes through
    ``from_flax_params`` (names and kernel layouts), and a count becomes
    an int. Built by ``build_optimizer`` with the same arguments, the
    port's chain has this very structure."""
    if hasattr(state, "_fields"):
        return {f: from_optax_state(getattr(state, f)) for f in state._fields}
    if isinstance(state, Mapping):
        return from_flax_params(state)
    if isinstance(state, (tuple, list)):
        return tuple(from_optax_state(s) for s in state)
    arr = np.asarray(state)
    if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
        return int(arr)
    raise TypeError(f"no port counterpart for optax state leaf {state!r}")


def load_npz(path: str, like: Any = None) -> Dict[str, torch.Tensor]:
    """``state_dict`` from a flattened ``.npz`` of a flax param tree (and
    its ``batch_stats``); ``like`` as for ``from_flax_params``."""
    tree: Dict[str, Any] = {}
    with np.load(path) as archive:
        for key in archive.files:
            node = tree
            *mods, leaf = key.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = archive[key]
    return from_flax_params(tree, like)


def as_state_dict(variables: Any, like: Any = None
                  ) -> Dict[str, torch.Tensor]:
    """Weights as the port takes them: a path to an ``.npz``, a flax tree
    (``{"params": ...}``, with its ``batch_stats``), or already a
    ``state_dict``. ``like``: the module they are for (conv kernels)."""
    if isinstance(variables, str):
        return load_npz(variables, like)
    if isinstance(variables.get("params"), Mapping):
        return from_flax_params(variables, like)
    return {k: torch.as_tensor(v) for k, v in variables.items()}
