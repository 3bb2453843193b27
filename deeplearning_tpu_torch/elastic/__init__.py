"""Elastic runs of the port: the counterpart of
``deeplearning_tpu/elastic``.

- ``signals``    — chained signal subscriptions (the flight recorder AND
  the preemption guard share SIGTERM; neither clobbers the other).
- ``preempt``    — SIGTERM/SIGINT → flush the in-flight checkpoint →
  :class:`Preempted` at the next step boundary → exit
  :data:`EXIT_PREEMPTED` (75), the supervisor's requeue signal.
- ``heartbeat``  — the step/activity watermark file the Trainer feeds
  and a supervisor reads.
- ``faults``     — ``DLTPU_FAULTS`` injection.
- ``supervisor`` — the slow-vs-wedged detector; the rest of the JAX
  supervisor comes with ROADMAP Queue 1 item 8c.
- ``topology``   — the fingerprint a checkpoint's ``topology.json``
  records (mesh, ranks, layout, weight-update mode).
- ``resume``     — ``elastic_restore``: the newest checkpoint onto the
  current mesh, resharded.

``topology`` and ``resume`` are imported by name, not here: they bring
the train step with them.
"""

from . import faults, heartbeat, preempt, signals, supervisor
from .preempt import EXIT_PREEMPTED, Preempted, PreemptionGuard

__all__ = ["signals", "preempt", "heartbeat", "faults", "supervisor",
           "EXIT_PREEMPTED", "Preempted", "PreemptionGuard"]
