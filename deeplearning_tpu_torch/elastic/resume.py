"""Cross-topology resume: restore a checkpoint onto whatever mesh exists —
the port of ``deeplearning_tpu/elastic/resume.py``.

``elastic_restore`` places a freshly built template state on the CURRENT
mesh under the CURRENT rules (``train.steps.shard_state``), restores the
newest intact checkpoint into it (a step holds global tensors; each rank
cuts them to its layout), and records a flight ``resume`` event saying
whether the topology changed and from what, read from the sidecar
``CheckpointManager.save(..., topology=...)`` wrote. The optimizer
moments come along: a ZeRO-1 step saved at one data-parallel extent
restores at another, or replicated, and a data-parallel step restores
onto data x model under ``TRANSFORMER_TP_RULES`` (and back), with the
moments bit for bit the saved values.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..core.checkpoint import CheckpointManager
from ..obs import flight
from ..parallel.mesh import Mesh
from ..parallel.sharding import Rules
from . import topology as topo

__all__ = ["elastic_restore"]


def elastic_restore(ckpt: CheckpointManager, state: Any, mesh: Mesh,
                    rules: Optional[Rules] = None,
                    step: Optional[int] = None,
                    zero1: bool = False) -> Tuple[Any, int]:
    """Restore the newest checkpoint (<= ``step``) onto ``mesh`` and
    return ``(state, step)``; with no checkpoint, the template placed on
    the mesh at step 0, so calling this at startup is the whole resume
    policy. ``zero1=True`` places the target with split moments. Every
    rank calls it."""
    from ..train.steps import shard_state
    target = shard_state(state, mesh, rules, zero1=zero1)
    restored, got = ckpt.restore_verified(target, step)
    if restored is None:
        return target, 0
    saved_topo = ckpt.topology(got)
    current = topo.current_topology(mesh)
    cross = topo.topology_changed(saved_topo, current)
    flight.record(
        "resume", step=int(got), cross_topology=bool(cross),
        saved_topology=topo.topology_str(saved_topo),
        current_topology=topo.topology_str(current))
    return restored, int(got)
