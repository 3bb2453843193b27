"""Deferred device metrics — the sync-free half of the Trainer; the port
of ``deeplearning_tpu/train/async_metrics.py``.

Reading a step's loss on the host waits for the card to finish that
step. ``DeferredMetrics`` decouples *enqueue* from *materialize*: the
Trainer pushes each step's dict of 0-d device tensors (a reference
append), and only entries at least ``lag`` pushes old are ever fetched;
by then their step has long retired, so the copy costs microseconds and
stalls nothing. A poll is ONE device-to-host transfer however many
entries it covers: the ready scalars are stacked on the device (as
float64, exact for float32 and int32 values) and copied with one
``.cpu()``, the counterpart of ``jax.device_get`` of a list.

``window=W`` sums on the device instead: each push folds the step's
metrics into a device-resident running sum (one ``_foreach_add_``, no
sync), and a closed window materializes as one dict of means (``bad_step``
stays a sum: "any bad step in the window" is ``sum > 0``).

``fetch_count`` counts sync events (one per materializing poll or drain),
``fetched_entries`` the entries (windows, in windowed mode).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["DeferredMetrics", "fetch_scalars"]

Entry = Tuple[Dict[str, Any], Dict[str, float]]   # (meta, host metrics)

# metric keys reported as window SUMS, not means
_SUM_KEYS = ("bad_step",)


def fetch_scalars(trees: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Every scalar of ``trees`` to the host in one transfer."""
    keys = [list(t) for t in trees]
    flat = [torch.as_tensor(t[k]).reshape(()).to(torch.float64)
            for t, ks in zip(trees, keys) for k in ks]
    host = torch.stack(flat).cpu().tolist() if flat else []
    out, i = [], 0
    for ks in keys:
        out.append(dict(zip(ks, host[i:i + len(ks)])))
        i += len(ks)
    return out


class DeferredMetrics:
    """FIFO ring of (meta, device-metrics) entries with lagged fetch.

    - ``push(tree, **meta)``: enqueue one step's dict of 0-d tensors and
      host metadata (epoch, it, data_time, ...). Never syncs.
    - ``poll()``: materialize (oldest first) every entry with at least
      ``lag`` newer pushes behind it; returns ``[(meta, host)]``.
    - ``drain()``: materialize everything still buffered.
    - ``window=W``: pushes fold into a running sum; a closed window is
      ready once ``lag`` pushes happened after it closed, and surfaces as
      one dict of means with the meta of its last step.
    """

    def __init__(self, lag: int = 1, window: Optional[int] = None):
        self.lag = max(int(lag), 0)
        self.window = max(int(window), 1) if window else None
        self._buf: collections.deque = collections.deque()
        self.fetch_count = 0        # sync events (materializing calls)
        self.fetched_entries = 0    # entries materialized in total
        self._push_idx = 0
        self._open_acc: Optional[Dict[str, torch.Tensor]] = None
        self._open_n = 0
        self._open_meta: Dict[str, Any] = {}

    def push(self, tree: Dict[str, Any], **meta: Any) -> None:
        self._push_idx += 1
        if self.window is None:
            self._buf.append((meta, tree))
            return
        if self._open_acc is None:
            # sums in each leaf's own dtype, as JAX's jitted add: a copy,
            # so the in-place adds leave the step's tensors alone
            self._open_acc = {k: torch.as_tensor(v).clone()
                              for k, v in tree.items()}
        else:
            names = list(self._open_acc)
            torch._foreach_add_([self._open_acc[k] for k in names],
                                [torch.as_tensor(tree[k]) for k in names])
        self._open_n += 1
        self._open_meta = meta
        if self._open_n >= self.window:
            self._close_window()

    def _close_window(self) -> None:
        if not self._open_n:
            return
        self._buf.append((self._open_meta, self._open_acc, self._open_n,
                          self._push_idx))
        self._open_acc, self._open_n, self._open_meta = None, 0, {}

    @property
    def pending(self) -> int:
        return len(self._buf) + (1 if self._open_n else 0)

    def __len__(self) -> int:
        return self.pending

    def poll(self) -> List[Entry]:
        ready = []
        if self.window is None:
            while len(self._buf) > self.lag:
                ready.append(self._buf.popleft())
        else:
            while self._buf and \
                    self._push_idx - self._buf[0][3] >= self.lag:
                ready.append(self._buf.popleft())
        return self._materialize(ready)

    def drain(self) -> List[Entry]:
        if self.window is not None:
            self._close_window()
        ready = list(self._buf)
        self._buf.clear()
        return self._materialize(ready)

    def _materialize(self, entries) -> List[Entry]:
        if not entries:
            return []
        self.fetch_count += 1
        self.fetched_entries += len(entries)
        if self.window is None:
            hosts = fetch_scalars([tree for _, tree in entries])
            return [(meta, host) for (meta, _), host in zip(entries, hosts)]
        hosts = fetch_scalars([acc for _, acc, _, _ in entries])
        return [(meta, {k: v if k in _SUM_KEYS else v / n
                        for k, v in host.items()})
                for (meta, _, n, _), host in zip(entries, hosts)]
