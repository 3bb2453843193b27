"""Deploy-time Conv + BatchNorm folding (yolov5 utils/torch_utils.py:211
``fuse_conv_and_bn`` analog) over the port's ``state_dict``: the
counterpart of ``deeplearning_tpu/export/fuse.py``, with its arithmetic.

Each BatchNorm's inference affine folds into the preceding conv's OIHW
weight (scaled along its output channels), so a runtime that expects
conv-only graphs can take the weights. The BatchNorm is rewritten to an
exact identity (mean 0, var 0, weight sqrt(eps)) rather than removed, so
the fused ``state_dict`` loads into the same module and reproduces the
unfused outputs up to one rounding.

Pairing is by the naming convention the port shares with the JAX package
(resnet.py, yolox.py, hrnet.py ConvBN): a sibling ``bnX`` folds into
``convX``; ``bn`` into ``conv``; inside a ConvBN-style wrapper the
children are literally ``conv`` / ``bn``. Explicit (conv, bn) module-name
pairs override.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["fuse_conv_bn"]


def _candidate_conv(bn_name: str, siblings) -> Optional[str]:
    stem = "conv" + bn_name[2:] if bn_name.startswith("bn") else ""
    for conv_name in (bn_name.replace("bn", "conv"),
                      bn_name.replace("_bn", "_conv"), stem):
        if conv_name and conv_name != bn_name and conv_name in siblings:
            return conv_name
    return None


def _join(parent: str, child: str) -> str:
    return f"{parent}.{child}" if parent else child


def _pairs(state: Dict[str, torch.Tensor]) -> List[Tuple[str, str]]:
    """(conv, bn) module names found by the naming convention."""
    children: Dict[str, set] = {}
    for key in state:
        mods = key.split(".")[:-1]
        for i in range(len(mods)):
            children.setdefault(".".join(mods[:i]), set()).add(mods[i])
    found = []
    for key in state:
        if not key.endswith(".running_mean"):
            continue
        bn = key[:-len(".running_mean")]
        parent, _, bn_name = bn.rpartition(".")
        if f"{bn}.weight" not in state:
            continue
        conv_name = _candidate_conv(bn_name, children.get(parent, ()))
        if conv_name is None:
            continue
        conv = _join(parent, conv_name)
        w = state.get(f"{conv}.weight")
        if w is not None and w.dim() >= 2:
            found.append((conv, bn))
    return found


def fuse_conv_bn(state: Dict[str, torch.Tensor], *,
                 pairs: Optional[Sequence[Tuple[str, str]]] = None,
                 eps: Union[float, Callable[[str], float]] = 1e-5,
                 verify: Optional[Callable[[Dict[str, torch.Tensor]],
                                           torch.Tensor]] = None,
                 verify_tol: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Return a new ``state_dict`` with every detected (conv, bn) pair
    folded. Names and shapes are unchanged, so it loads into the original
    module (``load_state_dict``) and runs in eval mode.

    ``eps`` MUST equal each BatchNorm's epsilon: both the folded multiplier
    and the identity rewrite depend on it. Pass a callable
    ``eps(bn_module_name) -> float`` for models mixing epsilons (e.g.
    ``lambda name: model.get_submodule(name).eps``).

    ``verify``: optional ``f(state_dict) -> tensor`` (typically a closure
    loading the weights into the model and running a probe batch in eval
    mode). The fused weights go through it beside the original ones; a
    max abs deviation above ``verify_tol`` raises, catching the silent
    mis-pairing or wrong epsilon the naming convention cannot."""
    fused = {k: v.detach().clone() for k, v in state.items()}
    for conv, bn in (_pairs(fused) if pairs is None else pairs):
        bn_eps = eps(bn) if callable(eps) else float(eps)
        gamma = fused[f"{bn}.weight"].to(torch.float32)
        beta = fused[f"{bn}.bias"].to(torch.float32)
        mean = fused[f"{bn}.running_mean"].to(torch.float32)
        var = fused[f"{bn}.running_var"].to(torch.float32)
        g = gamma * torch.rsqrt(var + bn_eps)

        kernel = fused[f"{conv}.weight"]
        shape = (-1,) + (1,) * (kernel.dim() - 1)   # output channels first
        fused[f"{conv}.weight"] = (kernel.to(torch.float32)
                                   * g.view(shape)).to(kernel.dtype)
        bias = fused.get(f"{conv}.bias")
        bias = (torch.zeros_like(mean) if bias is None
                else bias.to(torch.float32))
        fused_bias = (bias - mean) * g + beta
        if f"{conv}.bias" in fused:
            fused[f"{conv}.bias"] = fused_bias.to(kernel.dtype)
            fused[f"{bn}.bias"] = torch.zeros_like(beta)
        else:
            # the conv has no bias: the identity BatchNorm carries it
            fused[f"{bn}.bias"] = fused_bias
        # (z - 0) / sqrt(0 + eps) * sqrt(eps) == z exactly in real math
        root = torch.sqrt(torch.tensor(bn_eps, dtype=torch.float32))
        fused[f"{bn}.weight"] = torch.full_like(gamma, float(root))
        fused[f"{bn}.running_mean"] = torch.zeros_like(mean)
        fused[f"{bn}.running_var"] = torch.zeros_like(var)

    if verify is not None:
        ref = verify(state).detach().float()
        got = verify(fused).detach().float()
        dev = float((ref - got).abs().max())
        if not dev <= verify_tol:
            raise ValueError(
                f"fuse_conv_bn self-check failed: max|orig-fused|={dev:.3e} "
                f"> tol={verify_tol:.1e} — wrong epsilon or mis-paired "
                f"conv/bn (pass explicit pairs= or eps=)")
    return fused
