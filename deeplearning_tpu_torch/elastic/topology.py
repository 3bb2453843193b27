"""Topology fingerprints: what a checkpoint was written on — the port of
``deeplearning_tpu/elastic/topology.py``.

A checkpoint resumed on whatever capacity comes back records what it was
sharded over, so the resume can tell a same-topology restore from a
cross-topology reshard and leave a flight event saying which. The
fingerprint is a small JSON dict with the JAX package's fields: the
device and process counts (one card a rank: both the world size), the
platform (``gpu`` or ``cpu``), the mesh axis sizes, the shard-layout
summary of the saved state and the weight-update mode, which
``CheckpointManager.save(..., topology=...)`` writes beside each step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..parallel.mesh import Mesh, mesh_shape_str, world_size
from ..parallel.sharding import shard_layout_summary

__all__ = ["current_topology", "topology_changed", "topology_str"]


def _platform(mesh: Optional[Mesh], state: Optional[Any]) -> str:
    """``gpu`` or ``cpu``: where the mesh or the state lives, else the
    default device (JAX's ``jax.devices()[0].platform``)."""
    import torch
    if mesh is not None:
        dev = mesh.device
    else:
        params = getattr(state, "params", None) or {}
        dev = next((p.device for p in params.values()), None)
    if dev is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if dev.type == "cuda" else dev.type


def _infer_weight_update(state: Any) -> Optional[str]:
    """'zero1' when the moments are split while the params are not (the
    ZeRO-1 signature), 'replicated' when neither is; None for another
    layout (FSDP splits params too) or a state without a layout."""
    sh = getattr(state, "sharding", None)
    if sh is None:
        return None
    p = shard_layout_summary(sh.params)
    o = shard_layout_summary(sh.opt_state)
    if p["sharded"] == 0 and o["sharded"] > 0:
        return "zero1"
    if p["sharded"] == 0 and o["sharded"] == 0:
        return "replicated"
    return None


def current_topology(mesh: Optional[Mesh] = None,
                     state: Optional[Any] = None,
                     weight_update: Optional[str] = None) -> Dict[str, Any]:
    """The running job's fingerprint: ranks, platform, the mesh's axis
    sizes (given, or the one ``state`` is placed on), the state's layout
    summary and the weight-update mode (given by the Trainer, else read
    off the state's layouts)."""
    sh = getattr(state, "sharding", None)
    if mesh is None and sh is not None:
        mesh = sh.mesh
    n = world_size()
    doc: Dict[str, Any] = {"device_count": n, "process_count": n,
                           "platform": _platform(mesh, state)}
    if mesh is not None:
        doc["mesh_shape"] = {str(k): int(v) for k, v in mesh.shape.items()}
        doc["mesh_str"] = mesh_shape_str(mesh)
    if sh is not None:
        doc["shard_layout"] = shard_layout_summary(sh.tree())
    if weight_update is None and state is not None:
        weight_update = _infer_weight_update(state)
    if weight_update is not None:
        doc["weight_update"] = weight_update
    return doc


def topology_changed(saved: Optional[Dict[str, Any]],
                     current: Dict[str, Any]) -> bool:
    """True when the resume differs from the save in a way that forces a
    reshard: device count, process count, mesh axis sizes, or (where both
    record one) the weight-update mode, whose ZeRO-1 moments are split
    where replicated ones are whole. A missing fingerprint counts as
    changed (the reshard path is always safe)."""
    if not saved:
        return True
    for key in ("device_count", "process_count"):
        if saved.get(key) != current.get(key):
            return True
    a, b = saved.get("mesh_shape"), current.get("mesh_shape")
    if a is not None and b is not None and dict(a) != dict(b):
        return True
    a, b = saved.get("weight_update"), current.get("weight_update")
    return a is not None and b is not None and a != b


def topology_str(doc: Optional[Dict[str, Any]]) -> str:
    if not doc:
        return "unknown"
    mesh = doc.get("mesh_str") or "?"
    return (f"{mesh} ({doc.get('device_count', '?')} devices, "
            f"{doc.get('process_count', '?')} processes, "
            f"{doc.get('platform', '?')})")
