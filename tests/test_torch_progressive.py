"""The port's JPEG and PNG decoder against cv2 and the JAX package's
native decoder, on the CPU: progressive JPEG (SOF2),
block smoothing, CMYK / YCCK, scans without Huffman tables, Adam7 PNG; the
test-side progressive encoder and its sequential twin; serving them.

Tolerance: none. Every RGB decode is bit-equal to ``cv2.imdecode`` (cv2 5.0,
libjpeg-turbo 3.1) at ``IMREAD_COLOR`` and ``IMREAD_REDUCED_COLOR_{2,4,8}``;
the fused JPEG -> I420 decode is bit-equal to the JAX package's
``native.decode_jpeg_i420`` (bytes, scale, pads, dims) on every file both
take with a complete scan script, and None where it falls back (CMYK /
YCCK). Where libjpeg refuses a file, so does the port.
"""
import http.client
import io
import json
import socket
import threading

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from fastvision_tpu import native
from fastvision_tpu_torch.data import codec
from fastvision_tpu_torch.data.codec import decode_image
from fastvision_tpu_torch.infer import Detector, VisionService, make_server
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.testing import (
    _png,
    _scene,
    _strip_dht,
    encode_baseline_jpeg,
    encode_progressive_jpeg,
    standard_jpeg_tables,
)
from test_torch_fast_decode import jax_native_jpeg  # noqa: F401 (a fixture)

# the JAX package's native build races on a cold temporary directory (a
# worker that loses keeps the letterbox-only library): the fixture builds it
# again, privately, where that happened
pytestmark = pytest.mark.usefixtures("jax_native_jpeg")

torch.set_num_threads(2)
REDUCED = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = ((1, 1), (7, 9), (16, 16), (23, 45), (40, 24), (67, 131), (120, 97))


def assert_like_cv2(buf: bytes, what: str = "") -> None:
    """Full and reduced decodes bit-equal to cv2's."""
    for f, flag in REDUCED.items():
        want = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
        assert want is not None, what
        got = codec.decode_jpeg_reduced(buf, f)
        assert got.shape == want.shape[:2] + (3,), (what, f)
        diff = got != want[..., ::-1]
        assert not diff.any(), f"{what} 1/{f}: {int(diff.sum())} bytes differ"


def assert_fused_like_jax(buf: bytes, what: str = "") -> None:
    for size in (64, 98):
        for target in (0, 4, 16):
            got = codec.decode_jpeg_i420(buf, size, 114, target)
            want = native.decode_jpeg_i420(buf, size, 114, target)
            assert (got is None) == (want is None), (what, size, target)
            if got is not None:
                np.testing.assert_array_equal(got[0], want[0], err_msg=f"{what} {size} {target}")
                assert got[1:] == want[1:], (what, size, target)


def _scans(buf: bytes) -> list[tuple[int, bytes, tuple]]:
    """(marker, segment bytes with its entropy-coded data, (Ns, Ss, Se, Ah,
    Al) for a scan) of each marker segment after SOI, EOI excluded."""
    out, pos = [], 2
    while buf[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(buf[pos + 2:pos + 4], "big")
        params = ()
        if buf[pos + 1] == 0xDA:
            ns = buf[pos + 4]
            b = buf[pos + 5 + 2 * ns:pos + 8 + 2 * ns]
            params = (ns, b[0], b[1], b[2] >> 4, b[2] & 15)
            while buf[end] != 0xFF or buf[end + 1] in (0, *range(0xD0, 0xD8)):
                end += 1
        out.append((buf[pos + 1], buf[pos:end], params))
        pos = end
    return out


def keep_scans(buf: bytes, keep) -> bytes:
    """The file with only the scans ``keep(Ns, Ss, Se, Ah, Al)`` accepts."""
    return buf[:2] + b"".join(seg for m, seg, p in _scans(buf) if m != 0xDA or keep(*p)) + b"\xff\xd9"


# ---- repair 0: scans naming a Huffman table no DHT defined ----

@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
def test_scans_without_dht_get_the_standard_tables(sampling):
    """cv2's encoder writes the standard tables; with its DHT segments
    removed (the Motion-JPEG convention) libjpeg installs them again, and so
    does the port: full, reduced and fused decodes bit-equal (a decoder
    without them raises "a scan uses an undefined Huffman table")."""
    rng = np.random.default_rng(len(sampling))
    for i, (h, w) in enumerate(SIZES):
        img = _scene(h, w, i) if i % 2 else rng.integers(0, 256, (h, w, 3), np.uint8)
        params = [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, i % 3]
        if sampling == "gray":
            img = img[..., 0]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        full = cv2.imencode(".jpg", img, params)[1].tobytes()
        bare = _strip_dht(full)
        assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
        assert_like_cv2(bare, f"{h}x{w}")
        np.testing.assert_array_equal(decode_image(bare), decode_image(full))
        assert_fused_like_jax(bare, f"{h}x{w}")


def test_undefined_table_slots_still_fail():
    """Only slots 0 and 1 have standard tables: a scan naming table 2 that
    no DHT defined, or an index past 3, fails as in libjpeg; a DHT defining
    slot 0 replaces the standard table."""
    img = _scene(24, 40, 1)
    bare = _strip_dht(cv2.imencode(".jpg", img)[1].tobytes())
    sos = bare.index(b"\xff\xda")
    for sel in (0x22, 0x02, 0x40):  # DC 2 / AC 2, AC 2, DC 4
        bad = bytearray(bare)
        bad[sos + 6] = sel  # the first component's table selectors
        assert cv2.imdecode(np.frombuffer(bytes(bad), np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="undefined Huffman table"):
            decode_image(bytes(bad))
    dqt, dht = standard_jpeg_tables(75)
    own = encode_baseline_jpeg(img, dqt, dht, redefine=True, interleaved=False)
    assert_like_cv2(own, "tables redefined between scans")


# ---- progressive ----

@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_progressive_cv2_matches_cv2(sampling):
    """cv2's progressive encoder (jpeg_simple_progression, optimized tables,
    EOB runs, successive approximation) at each sampling over odd sizes,
    noise and scenes, with restarts in turn; the fused decode as the JAX
    package's."""
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate(SIZES):
        for q in (50, 95):
            img = _scene(h, w, i + q) if i % 2 else rng.integers(0, 256, (h, w, 3), np.uint8)
            buf = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, q,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, (0, 1, 3)[i % 3]])[1].tobytes()
            assert buf[buf.index(b"\xff\xc2"):][:2] == b"\xff\xc2"
            assert_like_cv2(buf, f"{h}x{w} q{q}")
            if q == 95:
                assert_fused_like_jax(buf, f"{h}x{w}")


def test_progressive_pil_and_gray_match_cv2():
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate(SIZES):
        for sub in (0, 1, 2):
            bio = io.BytesIO()
            Image.fromarray(_scene(h, w, i)).save(bio, "JPEG", progressive=True, subsampling=sub,
                                                  quality=70 + 10 * sub,
                                                  restart_marker_blocks=i % 3)
            assert_like_cv2(bio.getvalue(), f"PIL {h}x{w} {sub}")
        gray = cv2.imencode(".jpg", rng.integers(0, 256, (h, w), np.uint8),
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
        assert_like_cv2(gray, f"gray {h}x{w}")
        assert_fused_like_jax(gray, f"gray {h}x{w}")


SCRIPT_CUTS = {
    "stops_at_al1": lambda ns, ss, se, ah, al: al >= 1,
    "dc_only": lambda ns, ss, se, ah, al: ss == 0,
    "dc_first_only": lambda ns, ss, se, ah, al: ss == 0 and ah == 0,
    "no_refinement": lambda ns, ss, se, ah, al: ah == 0,
}


@pytest.mark.parametrize("cut", list(SCRIPT_CUTS))
def test_incomplete_scripts_block_smoothed_as_cv2(cut):
    """Scripts that leave coefficients 1-9 short of full precision (or
    never code them): libjpeg-turbo 3.1 block-smooths every component
    (jdcoefct.c, the 5 x 5 DC neighbourhood; with DC interpolation when no
    AC coefficient was coded), at every output scale. Sizes cover 1- and
    2-block-wide components and a last iMCU row of fewer block rows."""
    for i, (h, w) in enumerate(SIZES + ((57, 8), (8, 57), (136, 71), (25, 200))):
        for j, sampling in enumerate(("420", "422", "444", "440")):
            buf = cv2.imencode(".jpg", _scene(h, w, i + j), [
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 85,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])[1].tobytes()
            assert_like_cv2(keep_scans(buf, SCRIPT_CUTS[cut]), f"{cut} {h}x{w} {sampling}")
        gray = cv2.imencode(".jpg", _scene(h, w, i)[..., 1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
        assert_like_cv2(keep_scans(gray.tobytes(), SCRIPT_CUTS[cut]), f"gray {cut} {h}x{w}")


def test_progressive_scan_header_checks():
    """jdphuff.c's start_pass checks: a DC scan with Se > 0, an AC scan of
    two components, Ss > Se, Al > 13, a refinement with Al != Ah - 1."""
    buf = cv2.imencode(".jpg", _scene(32, 48, 2), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    scans = [i for i, (m, _, _) in enumerate(_scans(buf)) if m == 0xDA]
    segs = _scans(buf)

    def with_params(k: int, ss: int, se: int, ahal: int) -> bytes:
        m, seg, (ns, *_) = segs[scans[k]]
        seg = bytearray(seg)
        seg[5 + 2 * ns:8 + 2 * ns] = bytes((ss, se, ahal))
        parts = [s for _, s, _ in segs]
        parts[scans[k]] = bytes(seg)
        return buf[:2] + b"".join(parts) + b"\xff\xd9"

    for k, ss, se, ahal in ((0, 0, 5, 0x01), (1, 9, 4, 0x02), (1, 1, 5, 0x0E), (5, 1, 63, 0x20)):
        bad = with_params(k, ss, se, ahal)
        assert cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="progressive scan"):
            decode_image(bad)
    m, seg, (ns, *_) = segs[scans[1]]  # an AC scan naming two components
    two = bytearray(segs[scans[0]][1][:5 + 2 * 2]) + bytes((1, 5, 0x02))
    two[2:5] = (len(two) - 2).to_bytes(2, "big") + b"\x02"
    parts = [s for _, s, _ in segs]
    parts[scans[1]] = bytes(two) + seg[5 + 2 * ns + 3:]
    bad = buf[:2] + b"".join(parts) + b"\xff\xd9"
    assert cv2.imdecode(np.frombuffer(bad, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="progressive scan"):
        decode_image(bad)


def test_progressive_without_tables_fails_as_libjpeg():
    """libjpeg's progressive decoder installs no standard tables: a
    progressive file without DHT fails in cv2 5.0, in the JAX package's
    native build and in the port; its sequential twin decodes."""
    dqt, dht = standard_jpeg_tables(85)
    img = _scene(30, 44, 5)
    bare = encode_progressive_jpeg(img, dqt, dht, tables=False)
    assert cv2.imdecode(np.frombuffer(bare, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="undefined Huffman table"):
        decode_image(bare)
    with pytest.raises(ValueError):
        native.decode_jpeg_i420(bare, 64)
    assert_like_cv2(encode_progressive_jpeg(img, dqt, dht, tables=False, progressive=False))


# ---- the test-side encoder ----

@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2), (1, 1), "gray"])
def test_progressive_encoder_and_its_twin(sampling):
    """`encode_progressive_jpeg`: its sequential twin is byte-equal to
    `encode_baseline_jpeg` of the same image and tables; the progressive
    file (EOB runs of one block, the standard tables) decodes in cv2 and in
    the port to the twin's pixels; the script stopping at Al = 1 decodes as
    cv2 decodes it; every file as cv2's at every scale."""
    dqt, dht = standard_jpeg_tables(90)
    rng = np.random.default_rng(6)
    for i, (h, w) in enumerate(SIZES):
        img = _scene(h, w, i) if i % 2 else rng.integers(0, 256, (h, w, 3), np.uint8)
        samp = (1, 1) if sampling == "gray" else sampling
        if sampling == "gray":
            img = img[..., 0]
        for restart in (0, 2):
            base = encode_baseline_jpeg(img, dqt, dht, sampling=samp, restart=restart)
            twin = encode_progressive_jpeg(img, dqt, dht, sampling=samp, restart=restart,
                                           progressive=False)
            assert twin == base
            prog = encode_progressive_jpeg(img, dqt, dht, sampling=samp, restart=restart)
            want = cv2.imdecode(np.frombuffer(base, np.uint8), cv2.IMREAD_COLOR)
            np.testing.assert_array_equal(
                cv2.imdecode(np.frombuffer(prog, np.uint8), cv2.IMREAD_COLOR), want)
            np.testing.assert_array_equal(decode_image(prog), decode_image(base))
            assert_like_cv2(prog, f"{h}x{w}")
            assert_like_cv2(encode_progressive_jpeg(img, dqt, dht, sampling=samp,
                                                    restart=restart, script="al1"))


# ---- CMYK / YCCK ----

def test_cmyk_and_ycck_match_cv2():
    """PIL's CMYK (Adobe, transform 0: stored as is), YCCK (Adobe transform
    2, and transform 1, which libjpeg also reads as YCCK), and CMYK without
    an Adobe marker: libjpeg's colour space, jdcolor.c's YCCK -> CMYK and
    OpenCV's CMYK -> BGR, at every scale, sequential and progressive; the
    fused decode falls back (None), as the JAX package's does."""
    rng = np.random.default_rng(7)
    dqt, dht = standard_jpeg_tables(80)
    for i, (h, w) in enumerate(SIZES):
        cmyk = np.concatenate([_scene(h, w, i), rng.integers(0, 256, (h, w, 1), np.uint8)], -1)
        for progressive in (False, True):
            bio = io.BytesIO()
            Image.fromarray(cmyk, "CMYK").save(bio, "JPEG", quality=85, progressive=progressive)
            pil = bio.getvalue()
            assert_like_cv2(pil, f"PIL CMYK {h}x{w}")
            for samp in ((2, 2), (1, 1)):
                ycck = encode_progressive_jpeg(cmyk, dqt, dht, sampling=samp, progressive=progressive)
                assert_like_cv2(ycck, f"YCCK {h}x{w} {samp}")
                at = ycck.index(b"Adobe") + 11
                assert_like_cv2(ycck[:at] + b"\x01" + ycck[at + 1:], "Adobe transform 1")
            app14 = pil.index(b"\xff\xee")
            bare = pil[:app14] + pil[app14 + 2 + int.from_bytes(pil[app14 + 2:app14 + 4], "big"):]
            assert_like_cv2(bare, "no Adobe marker")
            for buf in (pil, ycck):
                assert codec.decode_jpeg_i420(buf, 64) is None
                assert native.decode_jpeg_i420(buf, 64) is None


# ---- Adam7 PNG ----

@pytest.mark.parametrize("ctype,depths", [(0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                          (4, (8, 16)), (6, (8, 16))],
                         ids=["gray", "rgb", "palette", "gray_alpha", "rgba"])
def test_adam7_png_matches_cv2(ctype, depths):
    """Every colour type and depth interlaced, each pass filtered on its
    own (filters 0-4 in turn), from 1 x 1 (six empty passes) up, bit-equal
    to cv2's IMREAD_COLOR (libpng); the writer's non-interlaced files of
    the same rows decode to the same pixels."""
    rng = np.random.default_rng(ctype)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for depth in depths:
        for h, w in ((1, 1), (1, 2), (2, 1), (2, 3), (3, 3), (4, 4), (1, 9), (9, 1), (5, 7), (17, 30)):
            rows = rng.integers(0, 256, (h, -(-w * channels * depth // 8)), dtype=np.uint8)
            pal = rng.integers(0, 256, (2 ** depth, 3), dtype=np.uint8) if ctype == 3 else None
            for filters in ((0,), (1, 2, 3, 4, 0)):
                buf = _png(rows, ctype, depth, pal, interlace=1, filters=filters)
                want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
                got = decode_image(buf)
                np.testing.assert_array_equal(got, want, err_msg=f"{depth} {h}x{w} {filters}")
                np.testing.assert_array_equal(decode_image(_png(rows, ctype, depth, pal)), got)


# ---- serving ----

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_vision_service_answers_the_new_kinds():
    """A progressive, a CMYK and a table-less JPEG POSTed to the service:
    200 (a decoder that refuses them gives 400) with the detections of
    ``predict_batch`` on ``decode_image`` of the payload."""
    model = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(1))
    anchors = np.array([[[40, 30], [50, 40], [60, 50]]] * 3, np.float32) / np.array(
        [1, 2, 4], np.float32)[:, None, None]
    det = Detector(model, anchors, input_size=64, batch_size=1, conf_thres=0.01,
                   device="cpu", dtype=torch.float32)
    service = VisionService(det)
    img = _scene(48, 64, 9)
    progressive = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    bio = io.BytesIO()
    Image.fromarray(np.concatenate([img, img[..., :1]], -1), "CMYK").save(bio, "JPEG")
    tableless = _strip_dht(cv2.imencode(".jpg", img[..., ::-1])[1].tobytes())
    port = _free_port()
    srv = make_server(service, "127.0.0.1", port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        for body in (progressive, bio.getvalue(), tableless):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            c.request("POST", "/predict", body=body)
            r = c.getresponse()
            status, answer = r.status, r.read()
            c.close()
            assert status == 200, answer
            want = service._to_json(det.predict_batch([decode_image(body)])[0])
            assert json.loads(answer) == want and want["detection_scores"]
    finally:
        srv.batcher.shutdown()
        srv.shutdown()
        srv.server_close()
