"""Inference server CLI of the port (``tools/serve.py``).

  # stdin mode: one image / .npy / .npz path per line, one JSON answer
  # per image
  echo img.png | python -m deeplearning_tpu_torch.serve \\
      --model vit_base_patch16_224 --attn flash_hb
  # a trained checkpoint (a Trainer step directory), with flip-TTA
  echo img.jpg | python -m deeplearning_tpu_torch.serve \\
      --model vit_base_patch16_224 --ckpt runs/x/ckpt/best --tta
  echo img.npy | python -m deeplearning_tpu_torch.serve \\
      --model swin_tiny_patch4_window7_224
  echo img.npy | python -m deeplearning_tpu_torch.serve \\
      --model yolox_s --size 640 --score-thresh 0.3
  echo img.npy | python -m deeplearning_tpu_torch.serve \\
      --model fasterrcnn_resnet50_fpn --size 800 --num-classes 20

  # HTTP mode (stdlib): POST /predict with an .npy body, GET /healthz,
  # GET /stats, GET /metrics (Prometheus text), GET /metrics.json,
  # POST /admin/drain, /admin/promote, /admin/brownout/<model>/<step>
  python -m deeplearning_tpu_torch.serve --model vit_base_patch16_224 \\
      --http 8000

  # a zoo: several models in one process (HTTP only); POST
  # /predict/<model>, GET /models, POST /admin/{load,evict}/<model>
  python -m deeplearning_tpu_torch.serve --http 8000 --zoo \\
      '{"vit": {"model": "vit_base_patch16_224", "buckets": [1, 8]},
        "vit8": {"model": "vit_base_patch16_224", "weight_quant": "int8"},
        "det": {"model": "yolox_s", "image_size": 640}}'

A stdin request is an image file (decoded by ``data/datasets.load_image``;
a classifier's frame goes through ``classification_eval_transform``, a
detector's is resized and divided by 255, as in ``tools/serve.py``) or a
model-ready float32 array (H, W, 3) or (n, H, W, 3): an ``.npy`` file, or
an ``.npz`` with an ``images`` array; frames of another size are resized
(``load_request_images``). An HTTP request is an ``.npy`` body. A
classifier answers ``{"top": [[class, p], ...]}``; a detector (picked
from the name, e.g. ``yolox_s``, ``fasterrcnn_resnet50_fpn``) answers
``{"detections": [{"box", "score", "label"}, ...]}`` with its valid rows
only: the padded
class −1 slots never leave the server. Labels are 0-based foreground
classes for every family (``--num-classes`` of them; Faster R-CNN's head
is built with a background class besides). Every request
path goes through ``MicroBatcher.submit()``, so concurrent clients batch
together; a full queue answers 429 with ``retry_after_s`` and a request
past its deadline 504 (``X-Deadline-Ms`` tightens the deadline).
Weights come from ``--ckpt`` (a checkpoint of the port: a ``save_pytree``
directory or a Trainer step directory, EMA weights first), ``--weights``
(an ``.npz`` of a JAX parameter tree) or ``--seed``. ``--tta`` serves a
classifier's flip-TTA. The model runs on the card; ``--device cpu`` runs
it on the CPU.

Supervision (the supervisor's contract with its children, as in JAX):
``DLTPU_HEARTBEAT=<file>`` writes a heartbeat whose step is the batches
dispatched; ``DLTPU_STANDBY=1`` starts a warm standby that answers 503
until ``POST /admin/promote``; ``DLTPU_TRACE=1`` records the span timeline
and dumps it on a graceful exit to ``DLTPU_TRACE_FILE`` (default
``trace.json`` beside ``DLTPU_ENDPOINT_FILE``, else in the working
directory). In HTTP mode a ``preempt_replica`` fault (``DLTPU_FAULTS``)
drains the server and exits 75 (``elastic.preempt.EXIT_PREEMPTED``), and a
``crash_replica`` fault records a flight event and exits 1 at once.

``--zoo`` (inline JSON or ``@file.json``, see ``parse_zoo_spec``) serves
several tenants from one ``ModelZoo``: each hot-loads on its first request
(or ``preload``), answers 429 ``hbm_pressure`` when the card's memory
reading leaves nothing evictable, and is evicted least-recently-used past
``--hbm-alert-frac`` or ``--max-resident``. ``/metrics`` mirrors the
telemetry under the ``dltpu_serve_*`` / ``dltpu_zoo_*`` names, per tenant
with a ``model`` label; with ``DLTPU_ENDPOINT_FILE`` set the replica
writes its URL there. SIGTERM drains the server and exits 0.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

import numpy as np


def _resize(imgs: np.ndarray, size: int) -> np.ndarray:
    """(n, H, W, 3) frames to (n, size, size, 3) with the emulation of
    ``jax.image.resize(..., "bilinear")`` (``train/multiscale.py``)."""
    import torch

    from ..train.multiscale import _resize_images
    return _resize_images(torch.from_numpy(np.ascontiguousarray(imgs)),
                          (size, size)).numpy()


def load_request_images(path: str, size: int,
                        task: str = "classify") -> np.ndarray:
    """One request's model-ready (n, size, size, 3) float32 frames: an
    ``.npz`` (its ``images``) or an ``.npy`` array as it is; an image file
    through the classification eval transform, or for a detector resized
    and divided by 255 (``tools/serve.py``'s frames); frames of another
    size resized."""
    if path.endswith(".npz"):
        with np.load(path) as archive:
            imgs = archive["images"]
    elif path.endswith(".npy"):
        imgs = np.load(path, allow_pickle=False)
    else:
        from ..data.datasets import load_image
        raw = np.asarray(load_image(path), np.float32)
        if task == "detect":
            imgs = raw[None] / 255.0
        else:
            from ..data.transforms import classification_eval_transform
            fn = classification_eval_transform((size, size))
            imgs = fn({"image": raw[None]})["image"]
    imgs = np.asarray(imgs, np.float32)
    if imgs.ndim == 3:
        imgs = imgs[None]
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"{path}: images {imgs.shape} are not (n, H, W, 3)")
    if imgs.shape[1:3] != (size, size):
        imgs = _resize(imgs, size)
    return imgs


def format_answer(row, names, topk: int) -> dict:
    """One image's JSON answer: the top-k classes of a probability row, or
    the valid rows of a detection dict."""
    if isinstance(row, dict):
        keep = np.asarray(row["valid"], bool)
        return {"detections": [
            {"box": [round(float(x), 1) for x in b],
             "score": round(float(sc), 4),
             "label": names.get(int(c), int(c))}
            for b, sc, c in zip(np.asarray(row["boxes"])[keep],
                                np.asarray(row["scores"])[keep],
                                np.asarray(row["labels"])[keep])]}
    order = np.argsort(-row)[:topk]
    return {"top": [[names.get(int(i), int(i)), round(float(row[i]), 4)]
                    for i in order]}


def serve_stdin(batcher, size: int, names, topk: int, timeout_s: float,
                stream_in=None, stream_out=None,
                task: str = "classify") -> int:
    """Line protocol: path in, JSON out (one line per image; an .npz
    submits every row concurrently so they micro-batch together)."""
    from .admission import DeadlineExceeded, Rejected
    stream_in = stream_in or sys.stdin
    stream_out = stream_out or sys.stdout
    for line in stream_in:
        path = line.strip()
        if not path:
            continue
        try:
            images = load_request_images(path, size, task)
            handles = [batcher.submit(img, timeout_s=timeout_s)
                       for img in images]
        except Rejected as r:
            print(json.dumps({"error": "rejected", "path": path,
                              "retry_after_s": round(r.retry_after_s, 3)}),
                  file=stream_out, flush=True)
            continue
        except (OSError, ValueError, KeyError) as e:
            print(json.dumps({"error": repr(e), "path": path}),
                  file=stream_out, flush=True)
            continue
        for i, h in enumerate(handles):
            try:
                ans = format_answer(h.result(timeout=timeout_s), names,
                                    topk)
            except DeadlineExceeded:
                ans = {"error": "deadline_exceeded"}
            ans.update({"path": path, "image": i})
            print(json.dumps(ans), file=stream_out, flush=True)
    print(json.dumps(batcher.telemetry.snapshot()), file=sys.stderr,
          flush=True)
    return 0


_SERVE_COUNTER_NAMES = {
    "submitted": "dltpu_serve_requests_total",
    "completed": "dltpu_serve_completed_total",
    "rejected": "dltpu_serve_rejected_total",
    "timed_out": "dltpu_serve_timed_out_total",
    "batches": "dltpu_serve_batches_total",
    "shed_batches": "dltpu_serve_shed_batches_total",
}
_SERVE_GAUGE_KEYS = (
    "requests_per_s", "rejects_per_s", "completions_per_s", "window_s",
    "batch_occupancy", "queue_depth_mean", "e2e_ms_p50", "e2e_ms_p90",
    "e2e_ms_p99", "dispatch_ms_p50", "dispatch_ms_p90",
    "dispatch_ms_p99")


def _mirror_telemetry(reg, snap, labels=None):
    for key, name in _SERVE_COUNTER_NAMES.items():
        reg.counter(name, f"serve telemetry {key}",
                    labels=labels).set_total(snap.get(key, 0.0))
    for key in _SERVE_GAUGE_KEYS:
        if key in snap:
            reg.gauge(f"dltpu_serve_{key}", f"serve telemetry {key}",
                      labels=labels).set(snap[key])


def make_metrics_collector(batcher):
    """Scrape-time pull adapter: mirror ``ServeTelemetry.snapshot()``
    (rates, percentiles, cumulative counts) and ``engine.stats()`` into
    the registry under the ``dltpu_serve_*`` names. Counters use
    ``set_total`` (monotonic mirror).

    Zoo mode additionally mirrors every tenant lane under the SAME
    metric names with a ``model`` label plus per-model queue, warm,
    brownout, bytes and trace-count gauges and the zoo residency
    counters."""

    def _collect(reg):
        snap = batcher.telemetry.snapshot()
        _mirror_telemetry(reg, snap)
        reg.gauge("dltpu_serve_queue_depth",
                  "live micro-batch queue depth").set(
            float(batcher.queue_depth))
        reg.gauge("dltpu_serve_standby",
                  "1 while a warm spare out of rotation").set(
            1.0 if batcher.standby else 0.0)
        if batcher.zoo is None:
            for key, val in batcher.engine.stats().items():
                if isinstance(val, (int, float)) \
                        and not isinstance(val, bool):
                    safe = "".join(c if c.isalnum() else "_"
                                   for c in key)
                    reg.gauge(f"dltpu_engine_{safe}",
                              f"engine stats {key}").set(float(val))
            return
        zs = batcher.zoo.stats()
        for key in ("registered", "resident", "loads", "evictions",
                    "rejected_loads"):
            reg.gauge(f"dltpu_zoo_{key}",
                      f"zoo {key}").set(float(zs[key]))
        for alias, row in zs["models"].items():
            labels = {"model": alias}
            lane_tel = batcher.lane_telemetry(alias)
            if lane_tel is not None:
                _mirror_telemetry(reg, lane_tel.snapshot(), labels)
            reg.gauge("dltpu_serve_queue_depth",
                      "live micro-batch queue depth",
                      labels=labels).set(
                float(batcher.lane_depth(alias)))
            reg.gauge("dltpu_zoo_model_warm", "1 while servable",
                      labels=labels).set(1.0 if row["warm"] else 0.0)
            reg.gauge("dltpu_serve_brownout_step",
                      "tenant degrade-ladder step (0 = full service)",
                      labels=labels).set(
                float(batcher.brownout_step(alias)))
            reg.gauge("dltpu_zoo_model_bytes", "resident weight bytes",
                      labels=labels).set(float(row["bytes"]))
            if "trace_count" in row:
                reg.gauge("dltpu_zoo_model_trace_count",
                          "engine trace count", labels=labels).set(
                    float(row["trace_count"]))
    return _collect


def serve_http(batcher, names, topk: int, timeout_s: float, port: int,
               wedge_deadline_s: float = 30.0):
    """Stdlib HTTP front: POST /predict (.npy body, one image or a batch)
    → JSON; GET /stats → telemetry + engine or zoo stats + the memory
    reading; GET /healthz → the health verdict with the dispatch wedge
    check; GET /metrics and /metrics.json → the scrape surface; POST
    /admin/drain, /admin/promote, /admin/brownout/<model>/<step> (step 2
    and up demote a zoo tenant to int8). Zoo mode (``batcher.zoo`` set)
    adds POST /predict/<model> (a cold tenant hot-loads in the background;
    a memory-pressure refusal answers 429 with the model and reason), GET
    /models and POST /admin/{load,evict}/<model>. ThreadingHTTPServer
    gives each request its own thread, so concurrent posts micro-batch.
    Returns the (not yet serving) server."""
    from concurrent.futures import TimeoutError as FutureTimeout
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..obs import metrics as obs_metrics
    from ..obs.xla import hbm_snapshot
    from .admission import DeadlineExceeded, Rejected
    from .health import DispatchWatch, health, zoo_health

    zoo = batcher.zoo
    watch = DispatchWatch(batcher, wedge_deadline_s)
    registry = obs_metrics.enable()
    registry.register_collector(make_metrics_collector(batcher))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet: telemetry is the log
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict, headers=()):
            self._send(code, json.dumps(payload).encode(),
                       "application/json", headers)

        def _rejected(self, r):
            # admission backpressure answers 429 ("slow down, retry
            # here"); a standby or chaos-injected refusal answers 503
            # ("wrong replica / failed attempt")
            code = 503 if r.reason in ("standby", "injected") else 429
            return self._json(
                code, {"error": "rejected", "reason": r.reason,
                       "model": r.model, "depth": r.depth,
                       "retry_after_s": round(r.retry_after_s, 3)},
                headers=[("Retry-After", f"{r.retry_after_s:.3f}")])

        def do_GET(self):
            route = self.path.rstrip("/")
            if route == "/stats":
                payload = batcher.telemetry.snapshot()
                if zoo is None:
                    payload["engine"] = batcher.engine.stats()
                else:
                    payload["zoo"] = zoo.stats()
                payload["hbm"] = hbm_snapshot()
                return self._json(200, payload)
            if route == "/models" and zoo is not None:
                return self._json(200, zoo.stats())
            if route == "/healthz":
                if zoo is None:
                    code, payload = health(batcher.engine, batcher,
                                           wedge=watch)
                else:
                    code, payload = zoo_health(zoo, batcher, wedge=watch)
                payload.update(obs_metrics.replica_identity())
                return self._json(code, payload)
            if route == "/metrics":
                return self._send(200, registry.prometheus_text().encode(),
                                  "text/plain; version=0.0.4; "
                                  "charset=utf-8")
            if route == "/metrics.json":
                return self._json(200, registry.snapshot())
            return self._json(404, {"error": "GET /stats, /healthz, "
                                             "/metrics or /metrics.json"})

        def _predict(self, alias):
            n = int(self.headers.get("Content-Length", 0))
            req_timeout = timeout_s
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr:
                try:
                    req_timeout = min(timeout_s, max(int(hdr), 1) / 1e3)
                except ValueError:
                    pass
            try:
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                images = np.asarray(arr, np.float32)
                if images.ndim == 3:
                    images = images[None]
                handles = [batcher.submit(img, timeout_s=req_timeout,
                                          model=alias)
                           for img in images]
                rows = [h.result(timeout=req_timeout) for h in handles]
            except Rejected as r:
                return self._rejected(r)
            except (DeadlineExceeded, FutureTimeout):
                return self._json(504, {"error": "deadline_exceeded"})
            except KeyError as e:
                return self._json(404, {"error": repr(e)})
            except Exception as e:  # noqa: BLE001 - request-scoped
                return self._json(400, {"error": repr(e)})
            return self._json(200, {"results": [
                format_answer(row, names, topk) for row in rows]})

        def do_POST(self):
            parts = [p for p in self.path.split("/") if p]
            if parts and parts[0] == "predict":
                if len(parts) == 1:
                    return self._predict(None)
                if len(parts) == 2 and zoo is not None:
                    return self._predict(parts[1])
            elif parts == ["admin", "drain"]:
                # stop accepting, finish the lanes; healthz flips to 503
                # "draining" so routers reroute
                batcher.drain()
                return self._json(200, {"draining": True,
                                        "drained": bool(batcher.drained),
                                        "queue_depth":
                                            batcher.queue_depth})
            elif parts == ["admin", "promote"]:
                # warm standby -> rotation: a flag flip
                return self._json(200, {"promoted": batcher.promote(),
                                        "standby": batcher.standby})
            elif (len(parts) == 4 and parts[0] == "admin"
                    and parts[1] == "brownout"):
                # one tenant's degrade-ladder step (0 restores); step 2+
                # also demotes a zoo tenant to int8 residency
                alias, step_s = parts[2], parts[3]
                try:
                    step = int(step_s)
                except ValueError:
                    return self._json(400,
                                      {"error": "step must be an int"})
                applied = batcher.set_brownout(alias, step)
                out = {"model": alias, "step": applied}
                if zoo is not None and applied >= 2:
                    out["demoted"] = zoo.demote_residency(alias)
                return self._json(200, out)
            elif (zoo is not None and len(parts) == 3
                    and parts[0] == "admin"
                    and parts[1] in ("load", "evict")):
                verb, alias = parts[1], parts[2]
                try:
                    if verb == "load":
                        state = zoo.load(alias, wait=False)
                    else:
                        evicted = zoo.evict(alias)
                        state = zoo.state(alias)
                except Rejected as r:
                    return self._rejected(r)
                except KeyError as e:
                    return self._json(404, {"error": repr(e)})
                out = {"model": alias, "state": state}
                if verb == "evict":
                    out["evicted"] = evicted
                return self._json(200, out)
            return self._json(404, {
                "error": "POST /predict[/<model>], /admin/drain, "
                         "/admin/promote, "
                         "/admin/brownout/<model>/<step> or "
                         "/admin/{load,evict}/<model>"})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    # server_close waits for the handlers in flight: a drain (SIGTERM, a
    # preemption) answers every request it admitted before the exit
    server.daemon_threads = False
    url = f"http://127.0.0.1:{server.server_port}"
    # advertise the scrape endpoint when a supervisor asked for it
    obs_metrics.write_endpoint(url, role="serve")
    endpoints = ["/predict", "/stats", "/healthz", "/metrics",
                 "/metrics.json", "/admin/drain", "/admin/promote",
                 "/admin/brownout/<model>/<step>"]
    if zoo is not None:
        endpoints[:1] = ["/predict/<model>", "/models",
                         "/admin/load/<model>", "/admin/evict/<model>"]
    print(json.dumps({"serving": url, "endpoints": endpoints}),
          flush=True)
    return server


def parse_zoo_spec(raw: str) -> dict:
    """``--zoo`` value: inline JSON or ``@file.json`` mapping alias →
    tenant spec. Per-tenant keys: ``model`` (architecture name,
    defaults to the alias), policy keys (``weight_quant``,
    ``max_queue``, ``shed_threshold``, ``timeout_s``, ``est_bytes``,
    ``preload``), ``buckets`` (list), and everything else passes
    through as engine kwargs (``num_classes``, ``image_size``,
    ``weights``, ``seed``, ``attn``, ``score_thresh``, ...)."""
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            spec = json.load(f)
    else:
        spec = json.loads(raw)
    if not isinstance(spec, dict) or not spec:
        raise ValueError("--zoo must map alias -> tenant spec")
    return spec


def build_zoo(spec: dict, args):
    """``ModelZoo`` from a parsed ``--zoo`` spec + CLI defaults: the
    CLI's buckets, queue, deadline, device and attention, and for a
    detector its score threshold, slots and NMS (a tenant's own keys
    win)."""
    from ..models.detection.predict import is_detection_model
    from .zoo import ModelZoo
    zoo = ModelZoo(alert_frac=args.hbm_alert_frac,
                   max_resident=args.max_resident)
    preload = []
    for alias, row in spec.items():
        row = dict(row)
        model_name = row.pop("model", alias)
        if row.pop("preload", False):
            preload.append(alias)
        buckets = row.pop("buckets", None)
        if buckets is not None:
            row["batch_buckets"] = tuple(int(b) for b in buckets)
        row.setdefault("batch_buckets", tuple(
            int(b) for b in args.buckets.split(",")))
        row.setdefault("device", args.device)
        row.setdefault("seed", args.seed)
        detector = is_detection_model(model_name)
        row.setdefault("num_classes", args.num_classes
                       or (80 if detector else 1000))
        if detector:
            row.setdefault("score_thresh", args.score_thresh)
            row.setdefault("max_det", args.max_det)
            row.setdefault("nms_impl", args.nms_impl)
        else:
            row.setdefault("attn", args.attn)
        zoo.register(
            alias, model_name,
            weight_quant=row.pop("weight_quant", "fp32"),
            max_queue=int(row.pop("max_queue", args.max_queue)),
            shed_threshold=row.pop("shed_threshold", None),
            default_timeout_s=row.pop("timeout_s", args.timeout_s),
            est_bytes=row.pop("est_bytes", None),
            **row)
    for alias in preload:
        zoo.load(alias, wait=True)
    return zoo


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default=None,
                    help="single-model mode: registry name, e.g. "
                         "vit_base_patch16_224")
    ap.add_argument("--zoo", default=None,
                    help="multi-tenant mode: JSON (or @file.json) "
                         "mapping alias -> tenant spec; see "
                         "parse_zoo_spec")
    ap.add_argument("--max-resident", type=int, default=None,
                    help="zoo: cap on simultaneously-warm models")
    ap.add_argument("--hbm-alert-frac", type=float, default=None,
                    help="zoo: evict when a load projects past this "
                         "fraction of the card's memory (default "
                         "DLTPU_HBM_ALERT_FRAC or 0.9)")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="head classes (default 1000, a detector 80)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint of the port: a save_pytree or Trainer "
                         "step directory (EMA weights first)")
    ap.add_argument("--weights", default=None,
                    help=".npz of a JAX parameter tree (else --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn", default="flash_hb",
                    help="attention: flash_hb (default), flash, naive, "
                         "sdpa; for a Swin model naive runs the unfused "
                         "window attention and flash / flash_hb the fused "
                         "window-attention kernel; a detector has none")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--buckets", default="1,8,32",
                    help="comma-separated batch buckets")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--timeout-s", type=float, default=30.0,
                    help="per-request deadline")
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--score-thresh", type=float, default=0.3,
                    help="detection score threshold")
    ap.add_argument("--max-det", type=int, default=100,
                    help="detection slots an image")
    ap.add_argument("--nms-impl", default="auto",
                    help="detection NMS: auto (the CUDA kernel on the card), "
                         "pallas (the same), blocked, greedy")
    ap.add_argument("--tta", action="store_true",
                    help="classification flip-TTA (two forwards a batch)")
    ap.add_argument("--classes", default=None,
                    help="json mapping class index -> name")
    ap.add_argument("--http", type=int, default=None,
                    help="serve HTTP on this port instead of stdin "
                         "(0 = ephemeral)")
    ap.add_argument("--wedge-deadline-s", type=float, default=30.0,
                    help="healthz reports wedged after this many seconds "
                         "of queued-but-frozen dispatch")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.model is None) == (args.zoo is None):
        ap.error("pass exactly one of --model or --zoo")
    if args.zoo is not None and args.http is None:
        ap.error("--zoo requires --http (stdin mode is single-model)")

    from ..elastic import heartbeat as hb
    from ..obs import spans
    from .batcher import MicroBatcher

    # DLTPU_TRACE=1: the span timeline, dumped on a graceful exit (beside
    # the endpoint file when supervised, one trace a replica workdir)
    trace_path = None
    if os.environ.get("DLTPU_TRACE"):
        spans.enable()
        ep = os.environ.get("DLTPU_ENDPOINT_FILE")
        trace_path = os.environ.get("DLTPU_TRACE_FILE") or os.path.join(
            os.path.dirname(ep) if ep else ".", "trace.json")

    engine = zoo = None
    if args.zoo is not None:
        zoo = build_zoo(parse_zoo_spec(args.zoo), args)
        print(json.dumps({"ready": zoo.stats()}), file=sys.stderr,
              flush=True)
        task = "classify"          # a zoo serves HTTP only
    else:
        engine = _build_engine(args)
        print(json.dumps({"ready": engine.stats()}), file=sys.stderr,
              flush=True)
        task = engine.task
    names = {}
    if args.classes:
        with open(args.classes) as f:
            names = {int(k): v for k, v in json.load(f).items()}

    # DLTPU_HEARTBEAT=<file>: the dispatch loop advances the activity
    # watermark, so a wedged replica is told from a slow one
    beat = writer = None
    beat_path = os.environ.get(hb.ENV_VAR)
    if beat_path:
        beat = hb.Heartbeat()
        writer = hb.HeartbeatWriter(beat_path, beat).start()
    try:
        with MicroBatcher(engine, zoo=zoo, max_wait_ms=args.max_wait_ms,
                          max_queue=args.max_queue,
                          default_timeout_s=args.timeout_s,
                          heartbeat=beat,
                          standby=os.environ.get("DLTPU_STANDBY") == "1"
                          ) as batcher:
            if args.http is None:
                return serve_stdin(batcher, args.size, names, args.topk,
                                   args.timeout_s, task=task)
            return _serve_forever(batcher, args, names)
    finally:
        if trace_path is not None:
            tracer = spans.get_tracer()
            if tracer is not None:
                tracer.dump(trace_path)
        if writer is not None:
            writer.stop()


def _serve_forever(batcher, args, names) -> int:
    """HTTP mode until SIGTERM (drain, exit 0), a ``preempt_replica``
    fault (drain, exit 75) or a ``crash_replica`` fault (exit 1 at once,
    no drain, as a replica that died)."""
    import signal

    from ..elastic.preempt import EXIT_PREEMPTED
    from ..obs import flight
    from ..obs import threads as obs_threads

    server = serve_http(batcher, names, args.topk, args.timeout_s,
                        args.http, args.wedge_deadline_s)
    rc = {"rc": 0}

    def _drain(signum, frame):
        # SIGTERM shuts the server down from a helper thread, so
        # serve_forever returns instead of dying mid-request
        obs_threads.spawn(server.shutdown, name="serve-drain", daemon=True)
    try:
        signal.signal(signal.SIGTERM, _drain)
    except ValueError:
        pass           # non-main thread (embedded use)

    def _preempted():
        rc["rc"] = EXIT_PREEMPTED
        flight.record("serve_preempted", dispatched=batcher.dispatched)
        batcher.drain()
        obs_threads.spawn(server.shutdown, name="serve-preempt-drain",
                          daemon=True)
    batcher.on_preempt = _preempted

    def _crashed():
        flight.record("serve_crash", dispatched=batcher.dispatched)
        os._exit(1)
    batcher.on_crash = _crashed
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return rc["rc"]


def _build_engine(args):
    from .. import hub
    from ..models.detection.predict import head_classes, is_detection_model
    from .engine import InferenceEngine
    num_classes = args.num_classes or (
        80 if is_detection_model(args.model) else 1000)
    model, _ = hub.load(args.model,
                        num_classes=head_classes(args.model, num_classes),
                        weights=args.weights, ckpt=args.ckpt,
                        seed=args.seed, device=args.device,
                        **hub.model_kwargs(args.model, args.attn, args.size))
    return InferenceEngine(
        args.model, model=model, num_classes=num_classes,
        image_size=args.size, device=args.device,
        batch_buckets=tuple(int(b) for b in args.buckets.split(",")),
        tta=args.tta, score_thresh=args.score_thresh, max_det=args.max_det,
        nms_impl=args.nms_impl)


if __name__ == "__main__":
    raise SystemExit(main())
