"""The port's image reads against the JAX package's cv2 calls, route by
route, on the CPU.

Four routes, each with the JAX function it stands for:

- memory: `codec.decode_image` (serving) against
  ``VisionService._decode_bytes`` (``cv2.imdecode``: reading past the end
  of the buffer gives no image);
- file: `dataset.imread_rgb` against ``data.dataset.imread_rgb``
  (``cv2.imread``: libjpeg's stdio source reads a fake EOI at the end);
- reduced: `dataset.imread_rgb_scaled` against its JAX namesake
  (``IMREAD_REDUCED_COLOR_f``, the full decode where that gives None);
- fused: `codec.decode_jpeg_i420` against ``native.decode_jpeg_i420``
  (libjpeg-turbo 2.1.5's ``jpeg_mem_src`` with its fake EOI; the markers
  after a one-pass scan read to the EOI).

The kinds are `testing.cv2_parity_images`' 32 files, written by the tests with cv2
and testing.py's writers: corrupt and truncated JPEG, every BMP kind cv2
reads, PNG eXIf orientations, and formats only cv2 decodes (WebP, TIFF,
AVIF, JPEG 2000, GIF, PPM). Tolerance: none. Each case is bit-equal to the
JAX call, or raises where it returns None or raises. Each repeats with
``import cv2`` failing: the port's own decoders give the same pixels, and
the formats handed to cv2 raise NotImplementedError naming item 11.
"""
import os
import sys

import cv2
import numpy as np
import pytest

from fastvision_tpu import native as jnative
from fastvision_tpu.data import dataset as jdataset
from fastvision_tpu.infer.serving import VisionService as JaxVisionService
from fastvision_tpu_torch import testing
from fastvision_tpu_torch.data import codec
from fastvision_tpu_torch.data import dataset as tdataset
from test_torch_fast_decode import jax_native_jpeg  # noqa: F401 (a fixture)

FILES = testing.cv2_parity_images(0)
ROUTES = ("memory", "file", "reduced", "fused")
REDUCE_TARGET = 24  # the 72 x 96 JPEGs decode at 1/2
FUSED_SIZE = 64


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("cv2_parity")
    paths = {}
    for name, _, data in FILES:
        paths[name] = str(d / name)
        with open(paths[name], "wb") as f:
            f.write(data)
    return paths


def _call(fn):
    """fn() or the exception it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared by kind below
        return e


def _route(route: str, path: str, data: bytes, jax: bool):
    if route == "memory":
        return _call(lambda: JaxVisionService._decode_bytes(None, data) if jax
                     else codec.decode_image(data))
    if route == "file":
        return _call(lambda: (jdataset if jax else tdataset).imread_rgb(path))
    if route == "reduced":
        return _call(lambda: (jdataset if jax else tdataset).imread_rgb_scaled(path, REDUCE_TARGET))
    return _call(lambda: (jnative if jax else codec).decode_jpeg_i420(data, FUSED_SIZE, 114,
                                                                      REDUCE_TARGET))


def _assert_same(got, want, what: str) -> None:
    if isinstance(want, Exception) or want is None and not isinstance(got, tuple):
        assert isinstance(got, Exception) or got is None and want is None, (what, got, want)
        if isinstance(got, Exception):
            assert isinstance(got, ValueError), (what, got)
        return
    assert not isinstance(got, Exception), (what, got)
    if isinstance(want, np.ndarray):
        assert got.shape == want.shape and np.array_equal(got, want), what
        return
    if want is None:
        assert got is None, what
        return
    if len(want) == 2:  # imread_rgb_scaled: (image, original size)
        np.testing.assert_array_equal(got[0], want[0], err_msg=what)
        assert tuple(got[1]) == tuple(want[1]), what
        return
    np.testing.assert_array_equal(got[0], want[0], err_msg=what)  # the fused decode
    assert got[1:] == want[1:], what


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name,kind,data", FILES, ids=[f[0] for f in FILES])
def test_route_kind_as_jax(route, name, kind, data, written,
                           jax_native_jpeg, monkeypatch):  # noqa: F811 (the fixture)
    path = written[name]
    want = _route(route, path, data, jax=True)
    got = _route(route, path, data, jax=False)
    _assert_same(got, want, f"{name} on the {route} route")
    monkeypatch.setitem(sys.modules, "cv2", None)
    blocked = _route(route, path, data, jax=False)
    if kind != "cv2" or route == "fused":  # the fused decode hands nothing to cv2
        _assert_same(blocked, got, f"{name} on the {route} route without cv2")
    else:
        assert isinstance(blocked, NotImplementedError) and "item 11" in str(blocked) \
            and codec.image_format(data) in str(blocked), (name, route, blocked)


def test_the_routes_differ_where_cv2s_calls_do(written):
    """The end-of-data rule per route: a JPEG cut at half is an image on the
    file and fused routes (rows past the cut 128 gray) and raises on the
    memory route; a JPEG without its EOI raises on the memory route only;
    a frame marker inside a one-pass scan's data is ignored by cv2 and
    fatal to the fused decode (its jpeg_finish_decompress reads on)."""
    data = dict((n, d) for n, _, d in FILES)
    cut = data["jpeg_cut_half.jpg"]
    full = tdataset.imread_rgb(written["jpeg_cut_half.jpg"])
    assert full.shape == (72, 96, 3) and (full[-8:] == 128).all()
    assert codec.decode_jpeg_i420(cut, FUSED_SIZE) is not None
    with pytest.raises(ValueError, match="truncated"):
        codec.decode_image(cut)
    with pytest.raises(ValueError, match="truncated"):
        codec.decode_image(data["jpeg_no_eoi.jpg"])
    assert tdataset.imread_rgb(written["jpeg_no_eoi.jpg"]).shape == (72, 96, 3)
    marker = data["jpeg_frame_marker_in_scan.jpg"]
    assert codec.decode_image(marker).shape == (72, 96, 3)
    with pytest.raises(ValueError, match="second frame header"):
        codec.decode_jpeg_i420(marker, FUSED_SIZE)
    png = codec.decode_image(data["png_exif6.png"])
    assert png.shape == (41, 30, 3)
    assert tdataset.imread_rgb_scaled(written["png_exif6.png"], 8)[1] == (41, 30)


def test_port_decoder_errors_never_reach_cv2(monkeypatch):
    """A ValueError of the port's JPEG, PNG or BMP decoder is raised as it
    is: cv2 is never asked to decode what the port's decoder refused."""
    asked = []
    monkeypatch.setattr(codec, "cv2_decode", lambda *a, **k: asked.append(a))
    data = dict((n, d) for n, _, d in FILES)
    png = data["png_exif6.png"]
    for bad in (data["jpeg_cut_half.jpg"], data["arith_cut_half.jpg"], png[:len(png) // 2],
                png[:-20] + bytes([png[-20] ^ 1]) + png[-19:], data["bmp_rle8.bmp"][:200],
                data["bmp_pal4.bmp"][:60], b"BM" + bytes(60)):
        with pytest.raises(ValueError):
            codec.decode_image(bad)
    assert not asked
    codec.decode_image(data["webp_lossy.webp"])
    assert len(asked) == 1


def _bmp_cases():
    """BMP kinds drawn by seed: palettes of 1, 4 and 8 bits under every
    header, clipped palettes, RLE8 / RLE4 with deltas, end-of-line and
    end-of-bitmap escapes and cut streams, 16-bit 555 / 565 / other masks,
    24-bit, 32-bit with masks under 40-, 52-, 56- and 124-byte headers."""
    rng = np.random.default_rng(11)
    cases = []
    for it in range(3):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        for bpp in (1, 4, 8):
            n = 1 << bpp
            pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
            idx = rng.integers(0, n, (h, w)).astype(np.uint8)
            for header in (12, 40, 124):
                cases.append(testing.encode_bmp(idx, bpp, palette=pal, header=header,
                                                top_down=header == 124))
            cases.append(testing.encode_bmp(idx // 2, bpp, palette=pal[:max(1, n // 2)],
                                            colors_used=max(1, n // 2)))
        for bits, comp in ((8, 1), (4, 2)):
            blocky = (rng.integers(0, 1 << bits, (h, w)) // 3 * 3).astype(np.uint8)
            data = testing.bmp_rle(blocky[::-1], bits, int(rng.integers(1 << 16)))
            pal = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
            for cut in (len(data), len(data) // 2):
                cases.append(testing.encode_bmp(blocky, bits, palette=pal, compression=comp,
                                                data=data[:cut]))
        v = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
        for masks in (None, (0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F), (0xF00, 0xF0, 0xF)):
            cases.append(testing.encode_bmp(v, 16, compression=3 if masks else 0, masks=masks))
        px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        cases.append(testing.encode_bmp(px[..., :3], 24))
        for header in (40, 52, 56, 124):
            for masks in ((0xFF, 0xFF00, 0xFF0000), (0x3FF00000, 0xFFC00, 0x3FF),
                          (0xF0F, 0xF0, 0xF000), (0, 0xFF00, 0xFF)):
                cases.append(testing.encode_bmp(px, 32, header=header, compression=3, masks=masks))
    return cases


def test_bmp_kinds_as_cv2():
    """Every BMP kind cv2's decoder reads, bit-equal to ``cv2.imdecode``;
    what it gives no image for raises ValueError."""
    for k, data in enumerate(_bmp_cases()):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if want is None:
            with pytest.raises(ValueError):
                codec.decode_bmp(data)
            continue
        got = codec.decode_image(data)
        assert got.shape == want.shape and np.array_equal(got, want[..., ::-1]), k


def test_jpeg_cuts_and_restarts_as_cv2(tmp_path):
    """Cut anywhere in a sequential or progressive scan (with restart
    intervals, with and without an EOI after the cut), every restart marker
    replaced by each RSTn or dropped (jpeg_resync_to_restart's three
    actions): bit-equal to ``cv2.imdecode`` and ``cv2.imread`` on their
    routes, or raising where they give no image."""
    rng = np.random.default_rng(12)
    written = []

    def both(buf):
        path = str(tmp_path / f"{len(written)}.jpg")  # a new file: truncating one is slow
        written.append(path)
        with open(path, "wb") as f:
            f.write(buf)
        for got, want in ((_call(lambda: codec.decode_image(buf)),
                           cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)),
                          (_call(lambda: tdataset.imread_rgb(path)), cv2.imread(path))):
            if want is None:
                assert isinstance(got, ValueError), len(buf)
            else:
                assert np.array_equal(got, want[..., ::-1]), len(buf)

    img = testing._scene(40, 56, 12)
    for params in ([cv2.IMWRITE_JPEG_RST_INTERVAL, 2], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                   [cv2.IMWRITE_JPEG_RST_INTERVAL, 1, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]):
        buf = cv2.imencode(".jpg", img, params)[1].tobytes()
        sos = buf.index(b"\xff\xda")
        for cut in range(sos, len(buf), int(rng.integers(9, 15))):
            both(buf[:cut])
            both(buf[:cut] + b"\xff\xd9")
        rst = [i for i in range(sos, len(buf) - 1)
               if buf[i] == 0xFF and 0xD0 <= buf[i + 1] <= 0xD7]
        for i in rst[:3]:
            for m in range(0xD0, 0xD8):
                both(buf[:i + 1] + bytes([m]) + buf[i + 2:])
            both(buf[:i] + buf[i + 2:])
