"""Bad-sample quarantine: one corrupt file must not kill a run — a copy
of ``deeplearning_tpu/data/quarantine.py``.

At production scale the input set always contains poison — truncated
JPEGs, mislabeled rows, a decoder that segfault-adjacent-raises on one
file in ten million. The reference stacks die on the first one (the
DataLoader worker raises, the epoch dies with it). Here the loader's
per-sample fetch catches the exception, substitutes a known-good sample
from the same batch (keeping every batch the same shape),
and appends one JSON line to a ``quarantine.jsonl`` manifest — the
operator's list of files to delete or re-encode.

Substitution is only safe while poison is RARE: a dataset that is 30%
unreadable is a broken dataset, and silently training on 70% duplicated
survivors would be worse than crashing. The ``max_poisoned_frac``
threshold (checked once at least ``min_samples`` fetches have been
seen, so one early failure can't trip it) escalates to
:class:`PoisonedData` — a hard error the loader and Trainer propagate,
never quarantine.

Every quarantined sample also lands a ``quarantine`` flight event, so a
crash dump carries the count next to the rollback and checkpoint-retry
telemetry, and increments the ``dltpu_quarantine_total`` counter of
``obs/metrics.py`` (a no-op while no registry is enabled).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..obs import flight, metrics

__all__ = ["PoisonedData", "QuarantineLog", "quarantinable"]


class PoisonedData(RuntimeError):
    """Poisoned fraction crossed the threshold (or a whole batch failed)
    — substitution would silently distort training, so this is a hard
    error, never quarantined."""


def quarantinable(exc: BaseException) -> bool:
    """Per-SAMPLE failures are quarantinable; process-level failures
    (interrupts, OOM, the escalation itself) must propagate."""
    return isinstance(exc, Exception) and not isinstance(
        exc, (PoisonedData, MemoryError))


class QuarantineLog:
    """Append-only ``quarantine.jsonl`` manifest + poisoned-fraction
    accounting. Thread-safe: the loader's parallel path records from the
    consumer thread while workers keep fetching."""

    def __init__(self, path: str, *, max_poisoned_frac: float = 0.01,
                 min_samples: int = 100):
        self.path = os.path.abspath(path)
        self.max_poisoned_frac = float(max_poisoned_frac)
        self.min_samples = int(min_samples)
        self.quarantined = 0
        self.total = 0                 # every fetch attempt, good or bad
        self._lock = threading.Lock()

    @property
    def poisoned_frac(self) -> float:
        with self._lock:
            return self.quarantined / self.total if self.total else 0.0

    def note_ok(self, n: int = 1) -> None:
        with self._lock:
            self.total += int(n)

    def record(self, index: Any, exc: BaseException, *,
               step: Optional[int] = None,
               path: Optional[str] = None) -> None:
        """Log one quarantined sample (manifest line + flight event),
        then escalate if the poisoned fraction crossed the threshold."""
        entry: Dict[str, Any] = {
            "time": time.time(),
            "index": int(index) if isinstance(index, (int,)) else index,
            "error": repr(exc),
        }
        if step is not None:
            entry["step"] = int(step)
        if path is not None:
            entry["path"] = path
        with self._lock:
            self.quarantined += 1
            self.total += 1
            try:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
            except OSError:
                pass               # losing a manifest line beats dying
        flight.record("quarantine", **entry)
        metrics.inc("dltpu_quarantine_total")
        self.check_escalation()

    def check_escalation(self) -> None:
        with self._lock:
            total, bad = self.total, self.quarantined
        if total >= self.min_samples and \
                bad / total > self.max_poisoned_frac:
            raise PoisonedData(
                f"{bad}/{total} samples quarantined "
                f"({bad / total:.1%} > {self.max_poisoned_frac:.1%} "
                f"threshold) — the dataset is poisoned, not unlucky; "
                f"manifest: {self.path}")
