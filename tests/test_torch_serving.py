"""The port's serving path (fastvision_tpu_torch.infer.serving) against the
JAX package's (fastvision_tpu.infer.serving), and its HTTP contract.

Same weights (bridged), float32, the same JPEG bytes: the port decodes them
with its own decoder, the JAX package with cv2 (bit-equal, tests/
test_torch_codec.py). Images whose long side equals the input size, so that
the letterbox pads but does not resample (the two resamplers differ by up to
1 level). Tolerances, as tests/test_torch_detector.py's: the same classes in
the same order and the same count; boxes within 0.1 px; scores within 1e-4
relative (scores at or above the 0.3 threshold, rounded to 5 places).

The HTTP tests follow tests/test_infer.py's serving tests, on the port.
"""
import base64
import http.client
import json
import socket
import sys
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.infer import Detector as JaxDetector
from fastvision_tpu.infer import VisionService as JaxVisionService
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu_torch import cli
from fastvision_tpu_torch.infer import Detector, ServerClosing, VisionService, make_server
from fastvision_tpu_torch.infer import serving
from fastvision_tpu_torch.infer.serving import _MicroBatcher
from fastvision_tpu_torch.models import YOLOv3, yolov3_state_dict_from_jax
from fastvision_tpu_torch.ops.nms_kernel import suppression_mask_cuda

torch.set_num_threads(2)
SIZE = 96
ANCHORS = np.asarray(
    [[[60, 50], [70, 60], [80, 70]],
     [[40, 35], [50, 40], [55, 45]],
     [[20, 18], [28, 24], [34, 30]]],
    np.float32,
)
NAMES = ["a", "b", "c", "d"]


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def models():
    jm = JaxYOLOv3(num_classes=4,
                   backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    variables = jax.device_get(jm.init(jax.random.key(3), jnp.zeros((1, SIZE, SIZE, 3))))
    variables = {c: variables[c] for c in ("params", "batch_stats")}
    tm = YOLOv3(num_classes=4, stage_sizes=(1, 1, 1, 1, 1))
    tm.load_state_dict(yolov3_state_dict_from_jax(variables))
    return jm, variables, tm


def _detector(tm, **kw):
    kw = {"input_size": SIZE, "batch_size": 2, "conf_thres": 0.3, "class_names": NAMES,
          "device": "cpu", "dtype": torch.float32, **kw}
    return Detector(tm, ANCHORS, **kw)


@pytest.fixture(scope="module")
def service(models):
    return VisionService(_detector(models[2]))  # every request runs as a batch of 2


def _jpegs(seed, shapes=((SIZE, SIZE), (SIZE, 60), (50, SIZE)), quality=90):
    rng = np.random.default_rng(seed)
    return [cv2.imencode(".jpg", rng.integers(0, 256, hw + (3,), dtype=np.uint8),
                         [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes() for hw in shapes]


def _assert_json_close(got: dict, want: dict) -> None:
    assert set(got) == {"detection_classes", "detection_scores", "detection_boxes"}
    assert got["detection_classes"] == want["detection_classes"]
    np.testing.assert_allclose(got["detection_boxes"], np.reshape(want["detection_boxes"], (-1, 4)),
                               atol=0.1, rtol=0)
    np.testing.assert_allclose(got["detection_scores"], want["detection_scores"], rtol=1e-4, atol=0)


def test_vision_service_matches_jax(models):
    """The port's JSON against the JAX package's VisionService on the same
    JPEG bytes, the same weights, float32."""
    jm, variables, tm = models
    jsvc = JaxVisionService(JaxDetector(jm, variables, ANCHORS, input_size=SIZE, batch_size=2,
                                        conf_thres=0.3, class_names=NAMES, dtype=jnp.float32))
    svc = VisionService(_detector(tm))
    bufs = _jpegs(0)
    total = 0
    for buf in bufs:
        got, want = svc.predict(buf), jsvc.predict(buf)
        _assert_json_close(got, want)
        assert all(isinstance(c, str) for c in got["detection_classes"])
        total += len(got["detection_scores"])
    assert total > 5
    for got, want in zip(svc.predict_many(bufs), jsvc.predict_many(bufs)):  # one batch of 3
        _assert_json_close(got, want)
    json.dumps(got)


def test_multi_label_detector_matches_jax(models):
    """Detector(multi_label=True), the serving NMS: the same (box, class)
    pairs as the JAX Detector's, one box under several classes allowed."""
    jm, variables, tm = models
    kw = dict(input_size=SIZE, batch_size=2, conf_thres=0.2, iou_thres=0.6, max_det=300)
    jdet = JaxDetector(jm, variables, ANCHORS, dtype=jnp.float32, multi_label=True, **kw)
    det = Detector(tm, ANCHORS, device="cpu", dtype=torch.float32, multi_label=True, **kw)
    images = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)[..., ::-1].copy()
              for b in _jpegs(1)]
    got, want = det.predict_batch(images), jdet.predict_batch(images)
    assert sum(len(r["boxes"]) for r in got) > 20
    assert any(len({tuple(b) for b in r["boxes"]}) < len(r["boxes"]) for r in got)  # a box, 2 classes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.1, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4, atol=0)
    with pytest.raises(ValueError, match="single-label"):
        det.evaluate_sweep([], [(0.25, 0.45)])


def test_service_decodes_without_cv2_or_pil(service, monkeypatch):
    """JPEG, PNG and BMP bodies decode with cv2 and PIL blocked; an
    undecodable body raises ValueError (HTTP 400): a truncated JPEG always
    (cv2.imdecode gives None), bytes of no known format where cv2 gives no
    image for them; without cv2 those raise NotImplementedError naming item
    11 (HTTP 400 too)."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (70, SIZE, 3), dtype=np.uint8)
    bodies = [cv2.imencode(ext, img)[1].tobytes() for ext in (".jpg", ".png", ".bmp")]
    want = [service.predict(b) for b in bodies]
    with pytest.raises(ValueError):
        service.predict(b"not an image")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert [service.predict(b) for b in bodies] == want
    assert want[1] == want[2]  # PNG and BMP hold the same pixels
    with pytest.raises(ValueError):
        service.predict(bodies[0][: len(bodies[0]) // 2])
    with pytest.raises(NotImplementedError, match="item 11"):
        service.predict(b"not an image")
    assert suppression_mask_cuda.launches == 0  # CPU tensors never reach the kernel


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(port, body, path="/predict", timeout=60):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, body=body)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def _get(port, path="/healthz"):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


@pytest.fixture
def server(service):
    servers = []

    def start(**kw):
        port = _free_port()
        srv = make_server(service, "127.0.0.1", port, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return srv, port

    yield start
    for srv in servers:
        srv.batcher.shutdown()
        srv.shutdown()
        srv.server_close()


def test_http_roundtrip_health_and_concurrency(service, server):
    """POST /predict answers with the service's JSON, garbage with 400;
    /healthz is live; concurrent POSTs are micro-batched without mixing
    results."""
    srv, port = server(batch_window_ms=50.0)
    status, health = _get(port, "/health")
    assert status == 200 and health["status"] == "ok" and health["queue_depth"] == 0
    bufs = _jpegs(3, shapes=((SIZE, SIZE), (60, SIZE), (SIZE, 70), (SIZE, SIZE)))
    status, ctype, body = _post(port, bufs[0])
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == service.predict(bufs[0])
    status, _, body = _post(port, b"garbage")
    assert status == 400 and "cannot decode image payload" in json.loads(body)["error"]
    assert _post(port, b"", "/nowhere")[0] == 404
    results = [None] * 4
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post(port, bufs[i])))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for buf, (status, _, body) in zip(bufs, results):
        assert status == 200
        assert json.loads(body) == service.predict(buf)


def test_healthz_body_cap_and_graceful_drain(service, server):
    """/healthz reports the warmed buckets and the queue depth; a body over
    the cap gets 413 before it is read; shutdown drains the queued requests
    (each gets 200 or 503), refuses new ones with 503 through the dedicated
    ServerClosing type, and /healthz then says draining."""
    service.warmup()
    assert service.warmed_buckets == [2]
    srv, port = server(batch_window_ms=30.0, max_body_mb=0.001)
    status, health = _get(port)
    assert health == {"status": "ok", "warmed_buckets": [2], "queue_depth": 0}
    status, _, body = _post(port, b"x" * 4096)
    assert status == 413 and "cap" in json.loads(body)["error"]
    buf = cv2.imencode(".jpg", np.random.default_rng(4).integers(0, 256, (24, 24, 3), np.uint8),
                       [cv2.IMWRITE_JPEG_QUALITY, 50])[1].tobytes()
    assert len(buf) <= 1024
    results = [None] * 4
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post(port, buf)))
               for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.005)
    assert srv.batcher.shutdown() is True
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r is not None and r[0] in (200, 503) for r in results), results
    assert any(r[0] == 200 for r in results)
    assert _post(port, buf)[0] == 503
    assert _get(port)[1]["status"] == "draining"
    with pytest.raises(ServerClosing):
        srv.batcher.predict(buf)
    assert not isinstance(RuntimeError("CUDA error"), ServerClosing)
    assert srv.batcher.shutdown() is True  # idempotent


def test_predict_stream_chunked_ndjson(service, server):
    """POST /predict_stream: NDJSON in, chunked NDJSON out, one line per
    image equal to the non-streaming result, over several device batches;
    a bad image mid-stream ends it with an error line."""
    _, port = server()
    bufs = _jpegs(5, shapes=((SIZE, SIZE), (SIZE, 50), (40, SIZE), (SIZE, 80), (SIZE, SIZE)))
    body = "\n".join(json.dumps({"image": base64.b64encode(b).decode()}) for b in bufs).encode()
    status, ctype, out = _post(port, body, "/predict_stream", timeout=120)
    assert status == 200 and ctype == "application/x-ndjson"
    lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert lines == service.predict_many(bufs) == [service.predict(b) for b in bufs]
    bad = body + b"\n" + json.dumps({"image": base64.b64encode(b"junk").decode()}).encode()
    lines = [json.loads(line) for line in _post(port, bad, "/predict_stream")[2].splitlines()
             if line.strip()]
    assert len(lines) == 5 and "error" in lines[-1]  # batches of 2: the third holds the junk


def test_microbatcher_adaptive_policy():
    """A lone request flushes after one idle quantum as a batch of 1; a
    burst arriving while the device is busy drains into a few large
    batches; a failed batch is retried one request at a time."""
    calls = []

    class FakeService:
        class detector:
            batch_size = 8

        def predict_many(self, payloads):
            calls.append(len(payloads))
            time.sleep(0.05)  # the device is busy: the burst queues behind this
            if any(p == b"bad" for p in payloads):
                raise ValueError("bad payload")
            return [{"n": int(p)} for p in payloads]

        def predict(self, payload):
            return self.predict_many([payload])[0]

    b = _MicroBatcher(FakeService(), window_ms="adaptive")
    try:
        assert b.adaptive and b.max_batch == 8
        t0 = time.perf_counter()
        assert b.predict(b"1") == {"n": 1}
        assert time.perf_counter() - t0 < 1.0 and calls == [1]
        calls.clear()
        results = [None] * 8
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, b.predict(str(i).encode()))) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert results == [{"n": i} for i in range(8)]
        assert sum(calls) == 8 and len(calls) <= 4 and max(calls) >= 4
        errors = []

        def bad():
            try:
                b.predict(b"bad")
            except ValueError as e:
                errors.append(e)

        threads = [threading.Thread(target=bad)] + [
            threading.Thread(target=lambda i=i: results.__setitem__(i, b.predict(str(i).encode())))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(errors) == 1 and results[:3] == [{"n": 0}, {"n": 1}, {"n": 2}]
    finally:
        assert b.shutdown() is True
    fixed = _MicroBatcher(FakeService(), window_ms=5.0)
    assert not fixed.adaptive and fixed.window == 0.005
    assert fixed.predict(b"7") == {"n": 7}
    assert fixed.shutdown() is True


def _small_yolo(cfg):
    return YOLOv3(num_classes=cfg.model.num_classes, stage_sizes=(1, 1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(cfg.train.seed))


def test_cli_serve_on_the_cpu(monkeypatch):
    """``serve --device cpu`` through cli.main in a thread: the serving
    preset (multi-label NMS at conf 0.001 / IoU 0.6, buckets 1, 2, 4 below
    batch 8) warms every bucket, then answers /healthz and /predict; the
    preset yields to the user's nms.* overrides."""
    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    servers, detectors = [], []
    real_make_server = serving.make_server

    def capture(service, *a, **kw):
        detectors.append(service.detector)
        servers.append(real_make_server(service, *a, **kw))
        return servers[-1]

    monkeypatch.setattr(serving, "make_server", capture)
    port = _free_port()
    argv = ["serve", "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
            "data.input_size=64", "model.num_classes=3", "train.bf16=false"]
    done = threading.Event()
    t = threading.Thread(target=lambda: (cli.main(argv), done.set()), daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while not servers:
        assert time.monotonic() < deadline and t.is_alive(), "serve never came up"
        time.sleep(0.05)
    det = detectors[0]
    assert (det.multi_label, det.conf_thres, det.iou_thres) == (True, 0.001, 0.6)
    assert det.batch_buckets == (1, 2, 4, 8) and det.device.type == "cpu"
    while True:
        try:
            status, health = _get(port)
            break
        except ConnectionRefusedError:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    assert status == 200 and health["warmed_buckets"] == [1, 2, 4, 8]
    buf = _jpegs(6, shapes=((48, 64),))[0]
    status, _, body = _post(port, buf)
    out = json.loads(body)
    assert status == 200 and len(out["detection_scores"]) > 0
    servers[0].batcher.shutdown()
    servers[0].shutdown()
    assert done.wait(30) and not t.is_alive()
    with pytest.raises(SystemExit, match="int8 serving needs calibration images"):
        cli.main(["serve", "--int8", "--device", "cpu", "data.data_root=/nonexistent"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["serve", "data.input_size=64"])
    cfg = cli._load_config(cli.make_parser().parse_known_args(["serve"])[0],
                           [*cli.SERVE_PRESET, "nms.conf_thres=0.1"])
    assert cfg.nms.conf_thres == 0.1 and cfg.nms.multi_label
