"""HTTP serving (port of fastvision_tpu/infer/serving.py).

The request contract of the reference's ModelArts service
(customize_service.py:344-488): image bytes -> decode + letterbox on the
host -> one device call (normalize, forward, decode, NMS on the card's
kernel) -> boxes unscaled to the original pixels -> JSON
{detection_classes, detection_scores, detection_boxes}, boxes as
[y1, x1, y2, x2] and scores rounded to 5 places.

`VisionService` decodes request bodies with the port's own decoder
(`data.codec.decode_image`: JPEG of every kind cv2 decodes, arithmetic-coded
and lossless included, PNG, BMP; no cv2), so a payload it refuses raises
ValueError, which the HTTP layer answers with 400.
`make_server` / `serve` put it behind the standard library's threaded HTTP
server: concurrent ``POST /predict`` requests are micro-batched into one
device call by `_MicroBatcher`, ``POST /predict_stream`` takes NDJSON and
answers in chunked NDJSON, ``GET /healthz`` reports the status, the warmed
batch buckets and the queue depth, and SIGTERM / SIGINT drain the queue.

The device work runs on the batcher's worker thread (and, for
``/predict_stream``, on the request's thread): each call selects the
detector's card first, and `Detector` sets inference mode and autocast
inside its own calls, because both are per thread.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..data.codec import decode_image, jpeg_library
from .predictor import Detector


class ServerClosing(RuntimeError):
    """Raised to callers whose request arrived after the graceful shutdown
    began: the one condition to retry elsewhere (HTTP 503). A type of its
    own, so that a CUDA error (a RuntimeError too) is not answered with 503."""


class VisionService:
    """preprocess -> infer -> postprocess -> a JSON-able dict."""

    def __init__(self, detector: Detector, class_names: Sequence[str] | None = None):
        self.detector = detector
        self.class_names = list(class_names) if class_names else detector.class_names
        self.warmed_buckets: list[int] = []
        device = detector.device
        # the card's index, fixed here: a thread's current card is its own
        self._card = None if device.type != "cuda" else (
            torch.cuda.current_device() if device.index is None else device.index)

    def _select_device(self) -> None:
        if self._card is not None:
            torch.cuda.set_device(self._card)

    def _decode_bytes(self, data: bytes) -> np.ndarray:
        return decode_image(data)

    def _to_json(self, res: dict) -> dict:
        names = self.class_names
        return {
            "detection_classes": [names[int(c)] if names else int(c) for c in res["classes"]],
            "detection_scores": [round(float(s), 5) for s in res["scores"]],
            # the serving box layout is y1, x1, y2, x2 (customize_service.py:472-488)
            "detection_boxes": [[float(b[1]), float(b[0]), float(b[3]), float(b[2])]
                                for b in res["boxes"]],
        }

    def predict(self, image_bytes: bytes) -> dict:
        return self.predict_many([image_bytes])[0]

    def warmup(self) -> None:
        """Build the decoder's library and the NMS kernel and run every batch
        bucket once before taking traffic, so that no request pays for a
        build or cuDNN's first choice of algorithms. `warmed_buckets` is what
        ``GET /healthz`` reports."""
        jpeg_library()
        self._select_device()
        dummy = np.zeros((64, 64, 3), np.uint8)
        for b in self.detector.batch_buckets:
            self.detector.predict_batch([dummy] * int(b))
        if self._card is not None:
            torch.cuda.synchronize(self._card)
        self.warmed_buckets = sorted(int(b) for b in self.detector.batch_buckets)

    def predict_many(self, payloads: Sequence[bytes]) -> list[dict]:
        """One device call for several requests (the micro-batching path)."""
        images = [self._decode_bytes(b) for b in payloads]
        self._select_device()
        return [self._to_json(r) for r in self.detector.predict_batch(images)]

    def predict_stream(self, payloads: Sequence[bytes]):
        """Yield one JSON-able result per payload, batch by batch (the
        detector's batch size at a time), so that a large job streams
        instead of waiting for the whole set (``POST /predict_stream``)."""
        bs = self.detector.batch_size
        for i in range(0, len(payloads), bs):
            yield from self.predict_many(payloads[i : i + bs])


class _MicroBatcher:
    """Gathers concurrent requests into one device call.

    Requests enqueue; a worker thread takes up to ``max_batch`` at a time
    and runs them through `VisionService.predict_many`; each caller waits on
    its own event. Window policies (how long to wait for more requests after
    the first one):

    - fixed (``window_ms`` a number): wait up to that long; a lone request
      always pays the whole window;
    - ``'adaptive'`` (the default): wait in quanta of ``QUANTUM`` and go on
      waiting only while the batch grows; one idle quantum flushes, and the
      wait is capped at ``max_window_ms``.

    A batch that fails is retried one request at a time, so that one bad
    payload fails only itself.
    """

    QUANTUM = 0.002  # s: the adaptive policy's idle-flush granularity

    def __init__(self, service: VisionService, max_batch: int | None = None,
                 window_ms: float | str = "adaptive", max_window_ms: float = 20.0):
        self.service = service
        self.max_batch = max_batch or service.detector.batch_size
        self.adaptive = window_ms == "adaptive"
        self.window = (max_window_ms if self.adaptive else float(window_ms)) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()  # orders the closed-check + put against shutdown
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def closed(self) -> bool:
        return self._closed

    def predict(self, payload: bytes) -> dict:
        slot = {"event": threading.Event(), "payload": payload}
        with self._lock:  # no slot may enqueue after the shutdown sentinel
            if self._closed:
                raise ServerClosing("server is shutting down")
            self._q.put(slot)
        slot["event"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def queue_depth(self) -> int:
        return self._q.qsize()

    def shutdown(self, timeout: float = 30.0) -> bool:
        """Graceful drain: refuse new requests, finish every queued one
        (each waiting caller gets its real result), then stop the worker.
        Idempotent. -> True when the backlog drained within ``timeout``."""
        with self._lock:
            if self._closed:
                return not self._thread.is_alive()
            self._closed = True
            self._q.put(None)  # the sentinel wakes the worker after the backlog
        self._thread.join(timeout)
        drained = not self._thread.is_alive()
        if not drained:
            print(f"[serve] WARNING: drain timed out after {timeout}s with "
                  f"~{self._q.qsize()} request(s) still queued")
        return drained

    def _gather(self, slots: list) -> None:
        """Fill ``slots`` up to max_batch by the window policy."""
        deadline = time.monotonic() + self.window
        while len(slots) < self.max_batch:
            now = time.monotonic()
            if now >= deadline:
                return
            q_deadline = min(now + self.QUANTUM, deadline) if self.adaptive else deadline
            grew = False
            while len(slots) < self.max_batch:
                remaining = q_deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    slots.append(self._q.get(timeout=remaining))
                    grew = True
                except queue.Empty:
                    break
            if not self.adaptive or not grew:
                return  # the fixed window elapsed, or an idle quantum: flush

    def _worker(self) -> None:
        while True:
            first = self._q.get()
            if first is None:  # the shutdown sentinel: the backlog is drained
                return
            slots = [first]
            self._gather(slots)
            if None in slots:  # the sentinel swept up: put it back, so the
                slots.remove(None)  # loop ends after this batch
                self._q.put(None)
                if not slots:
                    continue
            try:
                results = self.service.predict_many([s["payload"] for s in slots])
                for s, r in zip(slots, results):
                    s["result"] = r
            except Exception:  # noqa: BLE001 - isolate a bad payload
                for s in slots:
                    try:
                        s["result"] = self.service.predict(s["payload"])
                    except Exception as e:  # noqa: BLE001 - reported to its caller
                        s["error"] = e
            for s in slots:
                s["event"].set()


def serve(service: VisionService, host: str = "0.0.0.0", port: int = 8080,
          batch_window_ms: float | str = "adaptive") -> None:
    """Warm the service, then run it behind a threaded HTTP server until
    SIGTERM / SIGINT (or ``server.shutdown()``), which stop accepting,
    drain the micro-batch queue (every request in flight gets its result)
    and return. Signal handlers are installed only on the main thread; a
    ``serve`` in another thread is stopped through its server."""
    import signal

    print("[serve] warming the batch buckets...", flush=True)
    t0 = time.perf_counter()
    service.warmup()
    print(f"[serve] warmed buckets {service.warmed_buckets} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    server = make_server(service, host, port, batch_window_ms)

    def graceful(signum, frame):
        print(f"[serve] signal {signum}: draining the micro-batch queue...", flush=True)
        server.batcher.shutdown()
        # shutdown() must come from another thread than serve_forever's
        threading.Thread(target=server.shutdown, daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, graceful)
        signal.signal(signal.SIGINT, graceful)
    print(f"[serve] listening on {host}:{server.server_address[1]} "
          f"(POST /predict, POST /predict_stream, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    print("[serve] drained; bye", flush=True)


def make_server(service: VisionService, host: str = "127.0.0.1", port: int = 8080,
                batch_window_ms: float | str = "adaptive", max_body_mb: float = 32.0):
    """Build (but do not start) the HTTP server. It exposes ``.batcher``
    (``.batcher.shutdown()`` drains it). A request body above
    ``max_body_mb`` is answered with 413 before it is read."""
    import base64
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = _MicroBatcher(service, window_ms=batch_window_ms)
    max_body = int(max_body_mb * 1024 * 1024)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path.rstrip("/") in ("/health", "/healthz"):
                self._send(200, {"status": "draining" if batcher.closed else "ok",
                                 "warmed_buckets": service.warmed_buckets,
                                 "queue_depth": batcher.queue_depth()})
            else:
                self.send_error(404)

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def _stream(self, body: bytes) -> None:
            """``POST /predict_stream``: NDJSON lines {"image": "<base64>"}
            in; chunked NDJSON out, one result line per image, flushed as
            each device batch completes."""
            payloads = [base64.b64decode(json.loads(line)["image"])
                        for line in body.splitlines() if line.strip()]
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for res in service.predict_stream(payloads):
                    self._chunk(json.dumps(res).encode() + b"\n")
            except Exception as e:  # noqa: BLE001 - the headers are sent: report
                # a failure mid-stream as a last NDJSON line
                self._chunk(json.dumps({"error": str(e)}).encode() + b"\n")
            self._chunk(b"")  # the terminal zero-length chunk

        def do_POST(self):
            path = self.path.rstrip("/")
            if path not in ("", "/predict", "/predict_stream"):
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body:  # refuse before reading: a huge body is never buffered
                self._send(413, {"error": f"request body {length} B exceeds cap {max_body} B"})
                self.close_connection = True
                return
            body = self.rfile.read(length)
            try:
                if path == "/predict_stream":
                    self._stream(body)
                else:
                    self._send(200, batcher.predict(body))
            except ServerClosing as e:  # shutting down: retry elsewhere
                self._send(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - the serving boundary
                self._send(400, {"error": str(e)})

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    return server
