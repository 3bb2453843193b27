"""Sync-free metrics registry: Counter/Gauge/Histogram + /metrics — a
copy of ``deeplearning_tpu/obs/metrics.py``.

The scrape surface of a replica, train or serve: one uniform schema
(Prometheus text format on ``GET /metrics``, a JSON snapshot on
``GET /metrics.json``). Sources feed the registry two ways:

- **push**: hot-path sites call the module-level ``inc()`` /
  ``set_gauge()`` / ``observe()`` helpers (``HbmWatermark``, the
  Trainer's step/feed/recovery, quarantine, the zoo's loads and
  evictions).
- **pull**: ``register_collector(fn)`` hooks run at scrape time and
  mirror an existing telemetry surface (``ServeTelemetry.snapshot()``,
  ``engine.stats()``, ``zoo.stats()``) into gauges/counters — zero added
  cost on the request path.

Cost discipline:
- **Disabled** (the default): each helper is one module-pointer load
  plus an ``is None`` check — no lock, no allocation.
- **Enabled**: a dict lookup and one O(1) add under the metric's own
  lock. Histograms hold a fixed bucket array; nothing grows with
  traffic. Never a device sync — this module imports neither torch nor
  numpy, and scrape-time collection happens on the HTTP thread.

Identity: when a supervisor hands down ``DLTPU_RUN_ID`` /
``DLTPU_REPLICA``, the exposition carries a ``dltpu_replica_info``
gauge with those labels — the join key fleet scrapes, heartbeats, and
merged traces share.

Stdlib-only and importable standalone (no relative imports).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsServer",
    "enable", "disable", "get_registry", "enabled",
    "inc", "set_gauge", "observe",
    "replica_identity", "write_endpoint", "read_endpoint",
    "DEFAULT_BUCKETS_MS",
]

# module-level pointer: the `is None` check is the entire disabled-path
# cost (the spans.py discipline, applied to counters)
_REGISTRY: Optional["MetricsRegistry"] = None

# fixed latency-style bucket bounds (ms). Fixed at metric creation so
# enabled-path state is a constant-size int array, never a growing one.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# the env contract tools/supervise.py hands its children (also stamped
# into heartbeat files and trace metadata)
RUN_ID_VAR = "DLTPU_RUN_ID"
REPLICA_VAR = "DLTPU_REPLICA"
ENDPOINT_FILE_VAR = "DLTPU_ENDPOINT_FILE"


def replica_identity() -> Dict[str, str]:
    """{run_id, replica} from the supervisor-handed env, empty when
    unsupervised — the join key across /metrics, heartbeats, traces."""
    out: Dict[str, str] = {}
    run_id = os.environ.get(RUN_ID_VAR)
    replica = os.environ.get(REPLICA_VAR)
    if run_id:
        out["run_id"] = run_id
    if replica is not None and replica != "":
        out["replica"] = replica
    return out


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r} "
                         "(prometheus [a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v != v:                                   # NaN
        return "NaN"
    return repr(float(v))


class Counter:
    """Monotonic float counter. ``inc()`` is the push path;
    ``set_total()`` mirrors an external monotonic count at scrape time
    (pull collectors) — it never moves the value backwards, so the
    prometheus counter contract holds even when the source resets."""

    __slots__ = ("name", "help", "labels", "_lock", "_value")
    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = dict(labels) if labels else None
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set_total(self, value: float) -> None:
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def _sample(self) -> Dict[str, Any]:
        return {"type": self.kind, "help": self.help, "value": self._value}

    def _expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self._value)}"]


class Gauge(Counter):
    """Point-in-time value; ``set()`` overwrites, ``inc()`` adjusts."""

    __slots__ = ()
    kind = "gauge"

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class Histogram:
    """Fixed-bucket histogram: ``observe(v)`` bumps exactly one bucket
    slot plus sum/count under one lock — bounded state, O(buckets)
    exposition, never a growing ring."""

    __slots__ = ("name", "help", "labels", "buckets", "_lock",
                 "_counts", "_sum", "_count")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.name = _check_name(name)
        self.help = help
        self.labels = dict(labels) if labels else None
        bounds = tuple(sorted(float(b) for b in
                              (buckets or DEFAULT_BUCKETS_MS)))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)   # +1: the +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self.buckets)                    # default: +Inf slot
        for j, bound in enumerate(self.buckets):
            if v <= bound:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _cumulative(self) -> List[Tuple[str, int]]:
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for bound, c in zip(self.buckets, counts):
            running += c
            out.append((_fmt_value(bound), running))
        out.append(("+Inf", running + counts[-1]))
        return out

    def _sample(self) -> Dict[str, Any]:
        return {"type": self.kind, "help": self.help,
                "buckets": {le: c for le, c in self._cumulative()},
                "sum": round(self._sum, 6), "count": self._count}

    def _expose(self) -> List[str]:
        base = dict(self.labels) if self.labels else {}
        lines = []
        for le, c in self._cumulative():
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels({**base, 'le': le})} {c}")
        lab = _fmt_labels(self.labels)
        lines.append(f"{self.name}_sum{lab} {_fmt_value(self._sum)}")
        lines.append(f"{self.name}_count{lab} {self._count}")
        return lines


class MetricsRegistry:
    """One process's metric store: get-or-create metric handles plus
    scrape-time pull collectors. All ops are lock-light and host-only;
    exposition runs on the scraping thread, never a hot path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}       # name -> metric (ordered)
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []
        self.collect_errors = 0
        self.created = time.time()

    # ------------------------------------------------------ get-or-create
    def _get(self, name: str, factory: Callable[[], Any], kind: str,
             labels: Optional[Dict[str, str]] = None):
        # a labeled series is its own metric object keyed by
        # name+labelset (the prometheus data model: one timeseries per
        # distinct label combination under a shared metric name)
        key = name if not labels else name + _fmt_labels(labels)
        metric = self._metrics.get(key)          # GIL-safe fast path
        if metric is None:
            with self._lock:
                metric = self._metrics.get(key)
                if metric is None:
                    metric = factory()
                    self._metrics[key] = metric
        if metric.kind != kind:
            raise TypeError(f"metric {name!r} is a {metric.kind}, "
                            f"not a {kind}")
        return metric

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(name, lambda: Counter(name, help, labels),
                         "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(name, lambda: Gauge(name, help, labels),
                         "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(name,
                         lambda: Histogram(name, help, buckets, labels),
                         "histogram", labels)

    # --------------------------------------------------------- collectors
    def register_collector(
            self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """Scrape-time hook mirroring an existing telemetry surface into
        this registry (the pull path: zero hot-path cost)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - one bad source must not
                self.collect_errors += 1         # poison the whole scrape

    # --------------------------------------------------------- exposition
    def _info_metric(self) -> Optional[Gauge]:
        ident = replica_identity()
        if not ident:
            return None
        g = Gauge("dltpu_replica_info",
                  "replica identity handed down by the supervisor",
                  labels=ident)
        g.set(1.0)
        return g

    def _all_metrics(self) -> List[Any]:
        with self._lock:
            metrics = list(self._metrics.values())
        info = self._info_metric()
        return ([info] + metrics) if info is not None else metrics

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4 (# HELP / # TYPE +
        sample lines; histograms as cumulative _bucket/_sum/_count).
        Labeled series of one name are grouped under a single
        HELP/TYPE header, per the format's one-family-per-name rule."""
        self.collect()
        by_name: Dict[str, List[Any]] = {}
        for m in self._all_metrics():
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name, family in by_name.items():
            head = family[0]
            help_text = next((m.help for m in family if m.help), "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {head.kind}")
            for m in family:
                lines.extend(m._expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON view of the same state the text format exposes, plus
        identity — what the fleet tooling consumes.
        Unlabeled metrics keep their bare name as the key; labeled
        series are keyed ``name{label="value"}``."""
        self.collect()
        doc: Dict[str, Any] = {"time": time.time(),
                               **replica_identity(),
                               "collect_errors": self.collect_errors}
        doc["metrics"] = {m.name + _fmt_labels(m.labels): m._sample()
                          for m in self._all_metrics()}
        return doc

    def dump(self, path: str) -> str:
        """Write the JSON snapshot (``metrics_registry.json`` in a run
        dir)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f)
        os.replace(tmp, path)
        return path


# ----------------------------------------------------------------- toggles
def enable() -> MetricsRegistry:
    """Install (or return) the process-wide registry. Idempotent, like
    ``spans.enable()`` — layered callers share one scrape surface."""
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = MetricsRegistry()
    return _REGISTRY


def disable() -> Optional[MetricsRegistry]:
    """Uninstall; returns the registry (its state stays readable)."""
    global _REGISTRY
    reg, _REGISTRY = _REGISTRY, None
    return reg


def get_registry() -> Optional[MetricsRegistry]:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY is not None


# ------------------------------------------------------- hot-path helpers
def inc(name: str, n: float = 1.0,
        labels: Optional[Dict[str, str]] = None) -> None:
    """Counter bump; a no-op costing one ``is None`` check when the
    registry is disabled (hot-path safe by the spans discipline)."""
    reg = _REGISTRY
    if reg is None:
        return
    reg.counter(name, labels=labels).inc(n)


def set_gauge(name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
    reg = _REGISTRY
    if reg is None:
        return
    reg.gauge(name, labels=labels).set(value)


def observe(name: str, value: float,
            buckets: Optional[Sequence[float]] = None,
            labels: Optional[Dict[str, str]] = None) -> None:
    reg = _REGISTRY
    if reg is None:
        return
    reg.histogram(name, buckets=buckets, labels=labels).observe(value)


# --------------------------------------------------------- endpoint files
def write_endpoint(url: str, role: str,
                   path: Optional[str] = None,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Optional[str]:
    """Advertise this replica's scrape endpoint. A supervisor exports
    ``DLTPU_ENDPOINT_FILE`` per replica; the serving CLI / Trainer stats
    server write {url, role, pid, identity} there (tmp + atomic replace)
    for the fleet tooling to read back. Returns the path written, or
    None when unadvertised."""
    path = path or os.environ.get(ENDPOINT_FILE_VAR)
    if not path:
        return None
    doc: Dict[str, Any] = {"url": url, "role": role, "pid": os.getpid(),
                           "time": time.time(), **replica_identity()}
    if extra:
        doc.update(extra)
    d = os.path.dirname(os.path.abspath(path))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError:
        return None                    # advertising is best-effort
    return path


def read_endpoint(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and doc.get("url") else None


def _thread_registry():
    """The obs.threads spawn registry, resolvable even when this module
    was loaded standalone by file path: load the adjacent ``threads.py``
    under its canonical name so the process still has exactly one
    registry."""
    import sys
    mod = sys.modules.get("deeplearning_tpu_torch.obs.threads")
    if mod is None:
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "threads.py")
        spec = importlib.util.spec_from_file_location(
            "deeplearning_tpu_torch.obs.threads", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ stats server
class MetricsServer:
    """Opt-in stdlib scrape server: ``/metrics`` (text format),
    ``/metrics.json`` (snapshot), ``/healthz`` (delegates to
    ``healthz_fn() -> (code, payload)`` — the Trainer backs it with the
    elastic heartbeat so train replicas answer the same probe serve
    replicas do). Binds loopback; port 0 picks an ephemeral port."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 healthz_fn: Optional[
                     Callable[[], Tuple[int, Dict[str, Any]]]] = None):
        self.registry = registry
        self.host = host
        self._requested_port = int(port)
        self.healthz_fn = healthz_fn
        self.port: Optional[int] = None
        self.url: Optional[str] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None

    def _handler_class(self):
        from http.server import BaseHTTPRequestHandler
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet: the registry is the log
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                reg = outer.registry or _REGISTRY
                route = self.path.split("?", 1)[0].rstrip("/")
                if route == "/metrics":
                    if reg is None:
                        return self._send(503, b"registry disabled\n",
                                          "text/plain")
                    return self._send(
                        200, reg.prometheus_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                if route == "/metrics.json":
                    if reg is None:
                        return self._send(
                            503, b'{"error": "registry disabled"}',
                            "application/json")
                    return self._send(
                        200, json.dumps(reg.snapshot()).encode(),
                        "application/json")
                if route == "/healthz":
                    if outer.healthz_fn is not None:
                        code, payload = outer.healthz_fn()
                    else:
                        code, payload = 200, {"status": "alive",
                                              **replica_identity()}
                    return self._send(code, json.dumps(payload).encode(),
                                      "application/json")
                return self._send(404, b'{"error": "GET /metrics, '
                                  b'/metrics.json or /healthz"}',
                                  "application/json")
        return Handler

    def start(self) -> "MetricsServer":
        if self._server is not None:
            return self
        from http.server import ThreadingHTTPServer
        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), self._handler_class())
        self.port = self._server.server_port
        self.url = f"http://{self.host}:{self.port}"
        self._thread = _thread_registry().spawn(
            self._server.serve_forever, name="obs-metrics-http",
            daemon=True)
        return self

    def stop(self, timeout: float = 2.0) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
        self._server = None
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
