"""Inference server CLI of the port (single-model mode of ``tools/serve.py``).

  # stdin mode: one .npy/.npz path per line, one JSON answer per image
  echo img.npy | python -m deeplearning_tpu_torch.serve \\
      --model vit_base_patch16_224 --attn flash_hb
  echo img.npy | python -m deeplearning_tpu_torch.serve \\
      --model swin_tiny_patch4_window7_224
  echo img.npy | python -m deeplearning_tpu_torch.serve \\
      --model yolox_s --size 640 --score-thresh 0.3
  echo img.npy | python -m deeplearning_tpu_torch.serve \\
      --model fasterrcnn_resnet50_fpn --size 800 --num-classes 20

  # HTTP mode (stdlib): POST /predict with an .npy body, GET /healthz,
  # GET /stats
  python -m deeplearning_tpu_torch.serve --model vit_base_patch16_224 \\
      --http 8000

Requests are model-ready float32 arrays (H, W, 3) or (n, H, W, 3): an
``.npy`` file, or an ``.npz`` with an ``images`` array. A classifier
answers ``{"top": [[class, p], ...]}``; a detector (picked from the name,
e.g. ``yolox_s``, ``fasterrcnn_resnet50_fpn``) answers ``{"detections":
[{"box", "score", "label"}, ...]}`` with its valid rows only: the padded
class −1 slots never leave the server. Labels are 0-based foreground
classes for every family (``--num-classes`` of them; Faster R-CNN's head
is built with a background class besides). Every request
path goes through ``MicroBatcher.submit()``, so concurrent clients batch
together; a full queue answers 429 with ``retry_after_s`` and a request
past its deadline 504 (``X-Deadline-Ms`` tightens the deadline).
Weights come from ``--weights`` (an ``.npz`` of a JAX parameter tree) or
from ``--seed``. The model runs on the card; ``--device cpu`` runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import io
import json
import sys

import numpy as np


def load_request_images(path: str, size: int) -> np.ndarray:
    """One request's model-ready (n, size, size, 3) float32 frames."""
    if path.endswith(".npz"):
        with np.load(path) as archive:
            imgs = archive["images"]
    elif path.endswith(".npy"):
        imgs = np.load(path, allow_pickle=False)
    else:
        raise ValueError(f"{path}: requests are .npy or .npz arrays "
                         "(image decoding comes with the data slice)")
    imgs = np.asarray(imgs, np.float32)
    if imgs.ndim == 3:
        imgs = imgs[None]
    if imgs.shape[1:] != (size, size, 3):
        raise ValueError(f"{path}: images {imgs.shape[1:]} != "
                         f"({size}, {size}, 3)")
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
                stream_in=None, stream_out=None) -> int:
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
            images = load_request_images(path, size)
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


def serve_http(batcher, names, topk: int, timeout_s: float, port: int,
               wedge_deadline_s: float = 30.0):
    """Stdlib HTTP front: POST /predict (.npy body, one image or a batch)
    → JSON; GET /stats → telemetry + engine stats; GET /healthz → the
    health verdict with the dispatch wedge check. ThreadingHTTPServer
    gives each request its own thread, so concurrent posts micro-batch.
    Returns the (not yet serving) server."""
    from concurrent.futures import TimeoutError as FutureTimeout
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .admission import DeadlineExceeded, Rejected
    from .health import DispatchWatch, health

    watch = DispatchWatch(batcher, wedge_deadline_s)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet: telemetry is the log
            pass

        def _json(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            route = self.path.rstrip("/")
            if route == "/stats":
                payload = batcher.telemetry.snapshot()
                payload["engine"] = batcher.engine.stats()
                return self._json(200, payload)
            if route == "/healthz":
                return self._json(*health(batcher.engine, batcher,
                                          wedge=watch))
            return self._json(404, {"error": "GET /stats or /healthz"})

        def do_POST(self):
            if self.path.rstrip("/") != "/predict":
                return self._json(404, {"error": "POST /predict"})
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
                handles = [batcher.submit(img, timeout_s=req_timeout)
                           for img in images]
                rows = [h.result(timeout=req_timeout) for h in handles]
            except Rejected as r:
                return self._json(
                    503 if r.reason == "injected" else 429,
                    {"error": "rejected", "reason": r.reason,
                     "depth": r.depth,
                     "retry_after_s": round(r.retry_after_s, 3)},
                    headers=[("Retry-After", f"{r.retry_after_s:.3f}")])
            except (DeadlineExceeded, FutureTimeout):
                return self._json(504, {"error": "deadline_exceeded"})
            except (OSError, ValueError) as e:
                return self._json(400, {"error": repr(e)})
            return self._json(200, {"results": [
                format_answer(row, names, topk) for row in rows]})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    url = f"http://127.0.0.1:{server.server_port}"
    print(json.dumps({"serving": url,
                      "endpoints": ["/predict", "/healthz", "/stats"]}),
          flush=True)
    return server


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    help="registry name, e.g. vit_base_patch16_224")
    ap.add_argument("--num-classes", type=int, default=None,
                    help="head classes (default 1000, a detector 80)")
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
    args = build_parser().parse_args(argv)

    from .. import hub
    from ..models.detection.predict import head_classes, is_detection_model
    from ..obs import threads as obs_threads
    from .batcher import MicroBatcher
    from .engine import InferenceEngine

    num_classes = args.num_classes or (
        80 if is_detection_model(args.model) else 1000)
    model, _ = hub.load(args.model,
                        num_classes=head_classes(args.model, num_classes),
                        weights=args.weights, seed=args.seed,
                        device=args.device,
                        **hub.model_kwargs(args.model, args.attn, args.size))
    engine = InferenceEngine(
        args.model, model=model, num_classes=num_classes,
        image_size=args.size, device=args.device,
        batch_buckets=tuple(int(b) for b in args.buckets.split(",")),
        score_thresh=args.score_thresh, max_det=args.max_det,
        nms_impl=args.nms_impl)
    print(json.dumps({"ready": engine.stats()}), file=sys.stderr,
          flush=True)
    names = {}
    if args.classes:
        with open(args.classes) as f:
            names = {int(k): v for k, v in json.load(f).items()}

    with MicroBatcher(engine, max_wait_ms=args.max_wait_ms,
                      max_queue=args.max_queue,
                      default_timeout_s=args.timeout_s) as batcher:
        if args.http is None:
            return serve_stdin(batcher, args.size, names, args.topk,
                               args.timeout_s)
        server = serve_http(batcher, names, args.topk, args.timeout_s,
                            args.http, args.wedge_deadline_s)
        import signal

        def _drain(signum, frame):
            # SIGTERM shuts the server down from a helper thread, so
            # serve_forever returns instead of dying mid-request
            obs_threads.spawn(server.shutdown, name="serve-drain",
                              daemon=True)
        try:
            signal.signal(signal.SIGTERM, _drain)
        except ValueError:
            pass           # non-main thread (embedded use)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
