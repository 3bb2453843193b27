"""ModelZoo: N model sessions in one serving process, hot load/evict —
the port of ``deeplearning_tpu/serve/zoo.py``.

ONE serving process holds many resident :class:`~.engine.InferenceEngine`
sessions on the card and routes mixed traffic across them. The zoo is the
residency manager that makes that safe:

- **Registry-driven hot load.** ``register()`` records a model spec
  (engine kwargs + quota policy) without touching the device. The first
  request — or an admin load call — builds the engine on a background
  ``zoo-load-<alias>`` thread; the per-model state flips to ``"warm"``
  only after the constructor returns, i.e. after every batch bucket ran
  its warmup forward (``trace_count == len(buckets)``). Until then the
  dispatcher skips the tenant's lane, so no request ever pays a kernel
  build or a cold allocator.
- **Per-tenant contracts.** Every alias owns its bucket family and its
  engine's ``trace_count``/``compile_count``, and one
  ``AdmissionController`` (via ``TenantAdmission``), so queue quotas,
  deadlines, shed thresholds, and the EWMA drain rate behind
  ``retry_after_s`` are all per-model.
- **Memory-pressure LRU eviction.** Before a load, the zoo projects the
  model's bytes onto the worst device's ``usage_frac`` from
  ``obs/xla.hbm_snapshot`` (the card's own reading, ``mem_get_info``;
  tests stub the snapshot; the CPU reports no pressure). Crossing the
  alert fraction evicts the least-recently-used idle model first; when
  nothing is evictable the load is refused with ``Rejected`` (HTTP 429)
  instead of running the card out of memory. An eviction drops the
  engine and returns its blocks from PyTorch's caching allocator to the
  card (``torch.cuda.empty_cache``), so the reading falls with it.
- **Density.** ``weight_quant="int8"`` per spec stores resident weights
  as block-scaled int8 (``parallel/collectives.py``, dequantized inside
  each forward) — ~3.9x more weights per card.

Host-side manager: the request path through a warm engine does no zoo
work beyond a dict lookup and an LRU timestamp.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..obs import flight
from ..obs import metrics as obs_metrics
from ..obs import threads as obs_threads
from .admission import AdmissionController, Rejected, TenantAdmission

__all__ = ["ModelZoo", "ModelSpec"]

_DEFAULT_BUCKETS = (1, 8, 32, 128)
_DEFAULT_ALERT_FRAC = 0.9


class ModelSpec:
    """One registered tenant: how to build its engine + its quotas."""

    __slots__ = ("alias", "model_name", "engine_kwargs", "weight_quant",
                 "max_queue", "shed_threshold", "default_timeout_s",
                 "est_bytes", "engine_factory")

    def __init__(self, alias: str, model_name: Optional[str], *,
                 weight_quant: str = "fp32",
                 max_queue: int = 256,
                 shed_threshold: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 est_bytes: Optional[int] = None,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 **engine_kwargs: Any):
        self.alias = alias
        self.model_name = model_name
        self.engine_kwargs = dict(engine_kwargs)
        self.weight_quant = weight_quant
        self.max_queue = int(max_queue)
        self.shed_threshold = shed_threshold
        self.default_timeout_s = default_timeout_s
        self.est_bytes = est_bytes
        self.engine_factory = engine_factory

    @property
    def image_size(self) -> int:
        return int(self.engine_kwargs.get("image_size", 224))

    @property
    def buckets(self) -> tuple:
        return tuple(sorted(int(b) for b in self.engine_kwargs.get(
            "batch_buckets", _DEFAULT_BUCKETS)))


class ModelZoo:
    """Residency manager for N servable models in one process.

    States per alias: ``registered`` → ``loading`` → ``warm`` →
    (``evicted`` → ``loading`` → ``warm`` ...), with ``failed`` holding
    the last load error. ``request()`` is the submit-path entry: it
    returns immediately for a warm model, kicks a background load for a
    cold one (possibly evicting the LRU idle model first), and raises
    ``Rejected`` when HBM pressure leaves nothing evictable.
    """

    def __init__(self, *, alert_frac: Optional[float] = None,
                 hbm_snapshot_fn: Optional[Callable[[], Dict]] = None,
                 max_resident: Optional[int] = None):
        self._lock = threading.RLock()
        self._specs: Dict[str, ModelSpec] = {}
        self._engines: Dict[str, Any] = {}
        self._state: Dict[str, str] = {}
        self._last_used: Dict[str, float] = {}
        self._in_flight: Dict[str, int] = {}     # batches mid-dispatch
        self._resident_bytes: Dict[str, int] = {}  # survives evict
        self._load_threads: Dict[str, threading.Thread] = {}
        self._load_seconds: Dict[str, float] = {}
        self.load_errors: Dict[str, str] = {}
        self.admission = TenantAdmission()
        self.loads = 0
        self.evictions = 0
        self.rejected_loads = 0
        self._alert_frac = alert_frac
        self._hbm_fn = hbm_snapshot_fn
        self.max_resident = max_resident

    # -------------------------------------------------------- registry
    def register(self, alias: str, model_name: Optional[str] = None, *,
                 engine: Any = None, **spec_kwargs: Any) -> str:
        """Register one tenant. ``model_name`` + engine kwargs describe
        a lazy build; ``engine=`` installs a prebuilt (already warm)
        session immediately — the test seam, and the path for callers
        that built their engine elsewhere. ``engine_factory=`` defers to
        a zero-arg callable per (re)load."""
        if engine is not None and "engine_factory" not in spec_kwargs:
            spec_kwargs.setdefault("batch_buckets",
                                   tuple(engine.buckets))
            spec_kwargs.setdefault(
                "image_size", getattr(engine, "image_size", 224))
        spec = ModelSpec(alias, model_name, **spec_kwargs)
        with self._lock:
            if alias in self._specs:
                raise ValueError(f"model {alias!r} already registered")
            self._specs[alias] = spec
            self._state[alias] = "registered"
            self._in_flight[alias] = 0
            self.admission.configure(
                alias, spec.buckets, max_queue=spec.max_queue,
                shed_threshold=spec.shed_threshold,
                default_timeout_s=spec.default_timeout_s)
            if engine is not None:
                self._install(alias, engine, seconds=0.0)
        return alias

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._specs)

    def spec(self, alias: str) -> ModelSpec:
        spec = self._specs.get(alias)
        if spec is None:
            raise KeyError(f"model {alias!r} not registered "
                           f"(have {sorted(self._specs)})")
        return spec

    def state(self, alias: str) -> str:
        self.spec(alias)
        return self._state[alias]

    def image_size(self, alias: str) -> int:
        with self._lock:
            eng = self._engines.get(alias)
            if eng is not None:
                return int(eng.image_size)
            return self.spec(alias).image_size

    def admission_for(self, alias: str) -> AdmissionController:
        self.spec(alias)
        return self.admission.for_model(alias)

    # ------------------------------------------------------ request path
    def engine(self, alias: str) -> Optional[Any]:
        """The warm engine for ``alias``, or None while cold/loading —
        the dispatcher's per-batch lookup (one dict read)."""
        with self._lock:
            if self._state.get(alias) == "warm":
                return self._engines[alias]
            return None

    def touch(self, alias: str) -> None:
        # under the (reentrant) lock: also written by loader threads
        # via _install, and read by the eviction victim scan — an
        # unguarded write here was the textbook DLT200
        with self._lock:
            self._last_used[alias] = time.monotonic()

    def mark_dispatch(self, alias: str, delta: int) -> None:
        """Dispatch-thread bracket around a running batch: an engine
        with a batch in flight is never an eviction victim."""
        with self._lock:
            self._in_flight[alias] = max(
                0, self._in_flight.get(alias, 0) + delta)
        if delta > 0:
            self.touch(alias)

    def request(self, alias: str) -> str:
        """Submit-path hook: make sure ``alias`` is warm or on its way.
        Returns the state after the call ("warm" | "loading"). Raises
        ``Rejected`` when a needed load cannot be admitted (HBM
        pressure, nothing evictable) and ``KeyError`` for unregistered
        aliases."""
        with self._lock:
            st = self.state(alias)
            if st == "warm":
                self.touch(alias)
                return "warm"
            if st == "loading":
                return "loading"
            # registered / evicted / failed: (re)start the load
            self._ensure_capacity(alias)
            self._start_load(alias)
            return "loading"

    # ------------------------------------------------------------- load
    def load(self, alias: str, wait: bool = True,
             timeout_s: float = 600.0) -> str:
        """Admin load: kick (or join) the background load. With
        ``wait=True`` blocks until the warm flag flips (or the load
        fails)."""
        state = self.request(alias)
        if not wait or state == "warm":
            return self.state(alias)
        with self._lock:
            thread = self._load_threads.get(alias)
        if thread is not None:
            thread.join(timeout_s)
        return self.state(alias)

    def _start_load(self, alias: str) -> None:
        thread = self._load_threads.get(alias)
        if thread is not None and thread.is_alive():
            return
        self._state[alias] = "loading"
        thread = obs_threads.spawn(self._do_load, args=(alias,),
                                   name=f"zoo-load-{alias}",
                                   daemon=True, start=False)
        self._load_threads[alias] = thread
        thread.start()

    def _build_engine(self, spec: ModelSpec) -> Any:
        if spec.engine_factory is not None:
            return spec.engine_factory()
        from .engine import InferenceEngine
        if spec.model_name is None:
            raise ValueError(f"model {spec.alias!r} registered without "
                             "model_name, engine, or engine_factory")
        # precompile=True: the constructor runs every bucket's warmup
        # forward before it returns, which is what lets _do_load flip
        # the warm flag atomically after it
        return InferenceEngine(spec.model_name,
                               weight_quant=spec.weight_quant,
                               precompile=True, **spec.engine_kwargs)

    def _do_load(self, alias: str) -> None:
        spec = self.spec(alias)
        t0 = time.perf_counter()
        try:
            engine = self._build_engine(spec)
        except BaseException as e:  # noqa: BLE001 - surfaced in stats
            with self._lock:
                self._state[alias] = "failed"
                self.load_errors[alias] = repr(e)
            flight.record("zoo_load_failed", model=alias, error=repr(e))
            return
        seconds = time.perf_counter() - t0
        with self._lock:
            self._install(alias, engine, seconds=seconds)
        flight.record("zoo_load", model=alias,
                      seconds=round(seconds, 3),
                      bytes=self._resident_bytes.get(alias, 0),
                      weight_quant=spec.weight_quant)

    def _install(self, alias: str, engine: Any, seconds: float) -> None:
        """Under the lock: make a fully-warmed engine servable. This is
        the ONLY place the warm flag flips on — strictly after every
        bucket has run, never mid-warmup."""
        self._engines[alias] = engine
        try:
            self._resident_bytes[alias] = int(engine.variables_nbytes())
        except Exception:  # noqa: BLE001 - fakes may not implement it
            self._resident_bytes.setdefault(alias, 0)
        self._state[alias] = "warm"
        self._load_seconds[alias] = seconds
        self.load_errors.pop(alias, None)
        self.touch(alias)
        self.loads += 1
        obs_metrics.inc("dltpu_zoo_loads_total")
        obs_metrics.set_gauge("dltpu_zoo_resident_models",
                              float(len(self._engines)))

    # ------------------------------------------------------------ evict
    def evict(self, alias: str) -> bool:
        """Drop ``alias``'s engine (resident weights) — False when it
        isn't warm or has a batch in flight. The spec stays registered:
        the next request hot-reloads it fresh (a new engine, built from
        the same seed or weights)."""
        with self._lock:
            return self._evict_locked(alias)

    def _evict_locked(self, alias: str) -> bool:
        if self._state.get(alias) != "warm":
            return False
        if self._in_flight.get(alias, 0) > 0:
            return False
        engine = self._engines.pop(alias)
        on_card = getattr(getattr(engine, "device", None), "type",
                          None) == "cuda"
        del engine
        if on_card:
            # the caching allocator keeps freed blocks: hand them back to
            # the card, or mem_get_info never falls and the zoo would
            # evict every tenant and still refuse the load
            import torch
            gc.collect()
            torch.cuda.empty_cache()
        self._state[alias] = "evicted"
        self.evictions += 1
        obs_metrics.inc("dltpu_zoo_evictions_total")
        obs_metrics.set_gauge("dltpu_zoo_resident_models",
                              float(len(self._engines)))
        flight.record("zoo_evict", model=alias,
                      bytes=self._resident_bytes.get(alias, 0))
        return True

    def demote_residency(self, alias: str) -> bool:
        """Brownout step 2: re-pin ``alias`` to block-scaled int8
        residency. Flips the spec's ``weight_quant`` and evicts the
        fp32-resident engine so the next request hot-reloads it ~3.9x
        denser; a no-op (False) when the tenant is already int8 or not
        registered. Best-effort — a load in flight just means the
        eviction lands on a later call."""
        with self._lock:
            spec = self._specs.get(alias)
            if spec is None or spec.weight_quant == "int8":
                return False
            spec.weight_quant = "int8"
            self._evict_locked(alias)
        flight.record("zoo_demote", model=alias, weight_quant="int8")
        return True

    def _lru_victim(self, exclude: str) -> Optional[str]:
        candidates = [a for a, st in self._state.items()
                      if st == "warm" and a != exclude
                      and self._in_flight.get(a, 0) == 0]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda a: self._last_used.get(a, 0.0))

    # --------------------------------------------------------- pressure
    def alert_frac(self) -> float:
        if self._alert_frac is not None:
            return float(self._alert_frac)
        raw = os.environ.get("DLTPU_HBM_ALERT_FRAC")
        try:
            return float(raw) if raw else _DEFAULT_ALERT_FRAC
        except ValueError:
            return _DEFAULT_ALERT_FRAC

    def hbm_pressure(self) -> Dict[str, Any]:
        """Worst-device {usage_frac, bytes_in_use, bytes_limit} from the
        snapshot hook (``obs/xla.hbm_snapshot`` unless a test stubbed
        it). A device with no limit — the CPU — yields
        ``usage_frac=None``: no pressure signal, no eviction."""
        if self._hbm_fn is not None:
            snap = self._hbm_fn()
        else:
            from ..obs.xla import hbm_snapshot
            snap = hbm_snapshot()
        worst: Dict[str, Any] = {"usage_frac": None, "bytes_in_use": 0,
                                 "bytes_limit": 0}
        for dev in snap.get("devices") or []:
            limit = dev.get("bytes_limit") or 0
            in_use = dev.get("bytes_in_use") or 0
            if limit <= 0:
                continue
            frac = dev.get("usage_frac")
            frac = in_use / limit if frac is None else float(frac)
            if worst["usage_frac"] is None or frac > worst["usage_frac"]:
                worst = {"usage_frac": frac, "bytes_in_use": in_use,
                         "bytes_limit": limit}
        return worst

    def _est_bytes(self, alias: str) -> int:
        remembered = self._resident_bytes.get(alias)
        if remembered:
            return remembered
        return int(self.spec(alias).est_bytes or 0)

    def _ensure_capacity(self, alias: str) -> None:
        """Evict LRU idle models until ``alias`` projects under the
        alert fraction (and under ``max_resident``); ``Rejected`` when
        the projection still crosses with nothing left to evict."""
        limit_models = self.max_resident
        while (limit_models is not None
               and len(self._engines) >= limit_models):
            victim = self._lru_victim(exclude=alias)
            if victim is None or not self._evict_locked(victim):
                self.rejected_loads += 1
                raise Rejected(0, 1.0, model=alias,
                               reason="zoo_capacity")
            # loop: several residents may need to go
        freed = 0
        alert = self.alert_frac()
        while True:
            pressure = self.hbm_pressure()
            frac, limit = pressure["usage_frac"], pressure["bytes_limit"]
            if frac is None or limit <= 0:
                return                      # no signal: admit the load
            projected = frac + (self._est_bytes(alias) - freed) / limit
            if projected < alert:
                return
            victim = self._lru_victim(exclude=alias)
            if victim is None:
                self.rejected_loads += 1
                obs_metrics.inc("dltpu_zoo_load_rejects_total")
                flight.record("zoo_load_rejected", model=alias,
                              usage_frac=round(frac, 4),
                              projected_frac=round(projected, 4),
                              alert_frac=alert)
                raise Rejected(0, 1.0, model=alias,
                               reason="hbm_pressure")
            # count only the part of the victim's bytes the reading has
            # not shown: the card's reading falls by them as the eviction
            # empties the engine's pool; a reading that does not fall
            # (the CPU, an engine without a pool) keeps them all
            resident = self._resident_bytes.get(victim, 0)
            self._evict_locked(victim)
            drop = (pressure["bytes_in_use"]
                    - self.hbm_pressure()["bytes_in_use"])
            freed += max(0, resident - drop)

    def enforce_pressure(self) -> int:
        """Reactive sweep (admin / watermark hook): evict LRU models
        until current usage is back under the alert fraction. Returns
        the number evicted."""
        evicted = 0
        with self._lock:
            while True:
                pressure = self.hbm_pressure()
                frac = pressure["usage_frac"]
                if frac is None or frac < self.alert_frac():
                    return evicted
                victim = self._lru_victim(exclude="")
                if victim is None or not self._evict_locked(victim):
                    return evicted
                evicted += 1

    # ------------------------------------------------------ introspection
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            now = time.monotonic()
            models: Dict[str, Any] = {}
            for alias in sorted(self._specs):
                spec = self._specs[alias]
                row: Dict[str, Any] = {
                    "state": self._state[alias],
                    "warm": self._state[alias] == "warm",
                    "weight_quant": spec.weight_quant,
                    "buckets": list(spec.buckets),
                    "max_queue": spec.max_queue,
                    "bytes": self._resident_bytes.get(alias, 0),
                }
                if alias in self._last_used:
                    row["idle_s"] = round(
                        now - self._last_used[alias], 3)
                if alias in self._load_seconds:
                    row["load_seconds"] = round(
                        self._load_seconds[alias], 3)
                if alias in self.load_errors:
                    row["load_error"] = self.load_errors[alias]
                eng = self._engines.get(alias)
                if eng is not None:
                    row["trace_count"] = eng.trace_count
                    row["compile_count"] = eng.compile_count
                models[alias] = row
            return {
                "registered": len(self._specs),
                "resident": len(self._engines),
                "loads": self.loads,
                "evictions": self.evictions,
                "rejected_loads": self.rejected_loads,
                "alert_frac": self.alert_frac(),
                "models": models,
            }
