"""The port's image decoder (fastvision_tpu_torch.data.codec) against cv2.

Tolerance: none. Every decode is compared bit for bit with
``cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]`` (cv2 5.0 with
libjpeg-turbo and libpng): the committed corpus in tests/torch_codec_fixtures
(written by `testing.write_codec_fixtures`, with cv2's decodes beside it),
and JPEG / PNG files encoded here by cv2, PIL and the corpus's own baseline
encoder. Files the decoder does not take must raise ValueError naming what
is missing; none may decode to a partial image.
"""
import ctypes
import hashlib
import io
import json
import os
import re
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from PIL import Image

from fastvision_tpu_torch import cuda_build
from fastvision_tpu_torch.data import avi, codec, video_sampler
from fastvision_tpu_torch.data.codec import decode_image
from fastvision_tpu_torch.data.dataset import imread_rgb
from fastvision_tpu_torch.testing import _png, encode_baseline_jpeg, jpeg_tables

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_codec_fixtures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = ((1, 1), (2, 3), (8, 8), (9, 17), (16, 16), (23, 45), (40, 33), (67, 131))


def cv2_rgb(buf: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return np.ascontiguousarray(bgr[..., ::-1])


def assert_same_as_cv2(buf: bytes, what: str = "") -> None:
    got, want = decode_image(buf), cv2_rgb(buf)
    assert got.dtype == np.uint8 and got.shape == want.shape, (what, got.shape, want.shape)
    diff = got != want
    assert not diff.any(), f"{what}: {int(diff.sum())} bytes differ"


def noise(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c) if c else (h, w), dtype=np.uint8)


def smooth(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(x / rng.uniform(3, 20) + c) * np.cos(y / rng.uniform(3, 20))
                    for c in range(3)], -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_committed_corpus_matches_cv2(entry):
    """The corpus the card checks without cv2: each file's decode equals the
    stored cv2 pixels (the small files) or their sha256 (the full-size
    ones); the files that must raise do; each Motion-JPEG AVI gives cv2's
    frame counts and, frame by frame, ``cv2.imdecode``'s pixels."""
    path = os.path.join(FIXTURES, entry["file"])
    with open(path, "rb") as f:
        data = f.read()
    if "raises" in entry:
        with pytest.raises(ValueError, match=re.escape(entry["raises"])):
            decode_image(data)
        return
    if "video" in entry:
        want = entry["video"]
        video = avi.open_video(path)
        assert isinstance(video, avi.MJPEGAvi)
        assert (video.frame_count, video_sampler.count_real_frames(path), video.walk_count()) == \
            (want["frame_count"], want["real_frames"], want["read_loop_frames"])
        assert video.fps == want["fps"]
        got = [hashlib.sha256(f.tobytes()).hexdigest() for f in avi.open_video(path).frames()]
        assert got == want["frames_sha256"]
        return
    got = decode_image(data)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    if "full_" not in entry["file"]:
        with np.load(os.path.join(FIXTURES, "cv2_decodes.npz")) as stored:
            np.testing.assert_array_equal(got, stored[entry["file"]])


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_cv2_encoded_matches_cv2(sampling, quality):
    """cv2's encoder at every sampling and quality over odd sizes, noise
    (the IDCT's range limit) and smooth content, with optimized Huffman
    tables and restart intervals in turn."""
    rng = np.random.default_rng(quality * 7 + len(sampling))
    for i, (h, w) in enumerate(SIZES):
        for content in (noise(rng, h, w), smooth(rng, h, w)):
            params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
            if i % 2:
                params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
            if i % 3 == 1:
                params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 1 + i % 4]
            assert_same_as_cv2(cv2.imencode(".jpg", content, params)[1].tobytes(),
                               f"{h}x{w} {params}")


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_pil_encoded_matches_cv2(subsampling):
    """PIL's encoder (its own tables and markers), 4:4:4, 4:2:2 and 4:2:0,
    and a grayscale file."""
    rng = np.random.default_rng(subsampling)
    for h, w in SIZES:
        for quality in (60, 95):
            bio = io.BytesIO()
            Image.fromarray(smooth(rng, h, w)).save(bio, "JPEG", quality=quality,
                                                    subsampling=subsampling,
                                                    optimize=quality == 95)
            assert_same_as_cv2(bio.getvalue(), f"PIL {h}x{w} q{quality}")
    bio = io.BytesIO()
    Image.fromarray(noise(rng, 29, 41, 0), "L").save(bio, "JPEG", quality=80)
    assert_same_as_cv2(bio.getvalue(), "PIL gray")


def test_jpeg_grayscale_matches_cv2():
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(SIZES):
        params = [cv2.IMWRITE_JPEG_QUALITY, (50, 90, 100)[i % 3]]
        if i % 2:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
        buf = cv2.imencode(".jpg", noise(rng, h, w, 0), params)[1].tobytes()
        assert_same_as_cv2(buf, f"gray {h}x{w}")
        assert decode_image(buf).shape == (h, w, 3)


@pytest.mark.parametrize("little_endian", [True, False], ids=["II", "MM"])
def test_jpeg_exif_orientation_as_cv2_applies_it(little_endian):
    """Tag 0x0112 in either byte order: orientations 5-8 transpose (a 40 x 64
    image tagged 6 decodes as 64 x 40), values outside 1-8 change nothing."""
    rng = np.random.default_rng(6)
    base = cv2.imencode(".jpg", smooth(rng, 40, 64))[1].tobytes()
    e = "<" if little_endian else ">"
    for orientation in range(0, 10):
        tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
                + struct.pack(e + "HHHI", 1, 0x0112, 3, 1) + struct.pack(e + "HHI", orientation, 0, 0))
        body = b"Exif\0\0" + tiff
        buf = base[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + base[2:]
        assert_same_as_cv2(buf, f"orientation {orientation}")
        expect = (64, 40, 3) if orientation in (5, 6, 7, 8) else (40, 64, 3)
        assert decode_image(buf).shape == expect


@pytest.mark.parametrize("kw", [
    dict(interleaved=False), dict(interleaved=False, redefine=True),
    dict(interleaved=False, sampling=(1, 2), restart=3), dict(qt16=True),
    dict(qt16=True, interleaved=False, restart=7, sampling=(1, 1)), dict(sampling=(2, 1), restart=1),
], ids=["noninterleaved", "redefined_tables", "noninterleaved_440_restart", "qt16",
        "qt16_noninterleaved_restart", "422_restart_each_mcu"])
def test_jpeg_own_encoder_features_match_cv2(kw):
    """What cv2 does not write: one scan per component, tables redefined
    between scans (quantization table 0 overwritten after the luma scan,
    which both decoders must have latched), 16-bit quantization tables."""
    rng = np.random.default_rng(7)
    for h, w in ((37, 53), (8, 8), (61, 19)):
        img = smooth(rng, h, w)
        dqt, dht = jpeg_tables(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes())
        assert_same_as_cv2(encode_baseline_jpeg(img, dqt, dht, **kw), f"{h}x{w} {kw}")


def _patched(buf: bytes, at: bytes, offset: int, value: int) -> bytes:
    out = bytearray(buf)
    out[buf.index(at) + offset] = value
    return bytes(out)


def test_jpeg_kinds_not_taken_raise():
    """The kinds cv2 5.0 returns no image for raise naming item 11 and
    saying so: hierarchical (SOF5-7, SOF13-15), arithmetic lossless (SOF11),
    12-bit and a frame height left to a DNL marker, made by patching a
    baseline file's SOF (cv2 itself returns None for each). The kinds that
    raised here before decode as cv2 decodes them: progressive, CMYK, and
    the committed arithmetic-coded (SOF9, SOF10) and lossless (SOF3) files
    of libjpeg's and GDCM's encoders."""
    rng = np.random.default_rng(8)
    img = smooth(rng, 32, 48)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(noise(rng, 16, 16, 4), "CMYK").save(cmyk, "JPEG")
    for buf, what in ((bio.getvalue(), "progressive"), (cmyk.getvalue(), "CMYK")):
        assert_same_as_cv2(buf, what)
    for name in ("arith_seq_420_37x53.jpg", "arith_prog_420_47x66.jpg", "lossless_rgb_p1_37x53.jpg",
                 "lossless_cmyk_p1_21x30.jpg"):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert_same_as_cv2(f.read(), name)
    sof = base.index(b"\xff\xc0")
    cases = [(_patched(base, b"\xff\xc0", 1, m), "hierarchical")
             for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)]
    cases += [(_patched(base, b"\xff\xc0", 1, 0xCB), "arithmetic-coded lossless"),
              (_patched(base, b"\xff\xc0", 4, 12), "12-bit"),
              (base[:sof + 5] + b"\x00\x00" + base[sof + 7:], "DNL")]
    for buf, match in cases:
        assert cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR) is None, match
        with pytest.raises(ValueError, match=match) as e:
            decode_image(buf)
        assert "ROADMAP Queue 1, item 11" in str(e.value)
        assert "cv2 5.0 returns no image for it either" in str(e.value)


def test_jpeg_truncated_or_corrupt_raises(tmp_path):
    """The memory route (cv2.imdecode's source suspends past the end of the
    buffer): cut anywhere, or complete but for the EOI marker, ValueError,
    as cv2 returns None. The file route (cv2.imread: a fake EOI at the end)
    decodes the same cuts past the first scan's start as cv2.imread does,
    the rest of the scan from zero bits. A restart marker out of place or a
    flipped byte in the scan decodes as libjpeg recovers from it, on both."""
    rng = np.random.default_rng(9)
    buf = cv2.imencode(".jpg", noise(rng, 48, 64), [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes()
    sos = buf.index(b"\xff\xda")
    for k, cut in enumerate((3, 20, sos + 5, sos + 40, len(buf) // 2, len(buf) - 40,
                             len(buf) - 5, len(buf) - 2)):
        assert cv2.imdecode(np.frombuffer(buf[:cut], np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="truncated"):
            decode_image(buf[:cut])
        path = str(tmp_path / f"cut{k}.jpg")
        with open(path, "wb") as f:
            f.write(buf[:cut])
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        if want is None:
            assert cut < sos + 14
            with pytest.raises(ValueError, match="truncated"):
                imread_rgb(path)
        else:
            np.testing.assert_array_equal(imread_rgb(path), want[..., ::-1])
    rst = buf.index(b"\xff\xd0", sos)
    assert_same_as_cv2(buf[:rst + 1] + b"\xd3" + buf[rst + 2:], "RST3 for RST0")
    flipped = bytearray(buf)
    flipped[sos + 30] ^= 0x10
    assert_same_as_cv2(bytes(flipped), "a flipped byte in the scan")
    for payload in (b"", b"garbage", b"\x00" * 10, b"GIF89a...."):
        with pytest.raises(ValueError, match="cannot decode image payload"):
            decode_image(payload)
    with pytest.raises(ValueError, match="not a JPEG stream|truncated"):
        decode_image(b"\xff\xd8")


def _pil_png(img, **kw):
    bio = io.BytesIO()
    img.save(bio, "PNG", **kw)
    return bio.getvalue()


def test_png_types_and_depths_match_cv2():
    """Gray, RGB, palette, gray + alpha, RGBA at 1-8 and 16 bits, every
    filter cv2's and PIL's encoders choose, odd sizes."""
    rng = np.random.default_rng(10)
    for h, w in ((1, 1), (5, 7), (33, 47), (60, 90)):
        bufs = [cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, comp])[1].tobytes()
                for img, comp in ((noise(rng, h, w), 1), (smooth(rng, h, w), 9),
                                  (noise(rng, h, w, 0), 3), (noise(rng, h, w, 4), 6),
                                  (rng.integers(0, 65536, (h, w, 3), dtype=np.uint16), 3),
                                  (rng.integers(0, 65536, (h, w), dtype=np.uint16), 3),
                                  (rng.integers(0, 65536, (h, w, 4), dtype=np.uint16), 3))]
        for bits in (1, 2, 4, 8):
            pal = Image.fromarray(rng.integers(0, 2 ** bits, (h, w), dtype=np.uint8), "P")
            pal.putpalette(rng.integers(0, 256, 3 * 2 ** bits).tolist())
            bufs.append(_pil_png(pal, bits=bits))
        bufs += [_pil_png(Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))),
                 _pil_png(Image.fromarray(noise(rng, h, w, 2), "LA")),
                 _pil_png(Image.fromarray(smooth(rng, h, w)[..., 0], "L"), optimize=True)]
        for i, buf in enumerate(bufs):
            assert_same_as_cv2(buf, f"png {i} {h}x{w}")


def test_png_not_taken_or_corrupt_raises():
    """An Adam7 file decodes as cv2 decodes it (it raised here before); a
    non-interlaced file's rows read as Adam7 passes come up short and
    raise, as does an unknown interlace method; CRC errors and truncation
    raise."""
    rng = np.random.default_rng(11)
    adam7 = _png(noise(rng, 16, 16).reshape(16, -1), 2, 8, interlace=1, filters=(4, 3, 1))
    assert_same_as_cv2(adam7, "Adam7")
    buf = cv2.imencode(".png", noise(rng, 16, 16))[1].tobytes()
    ihdr = bytearray(buf[8:33])  # length, type, 13 bytes, crc
    for method, match in ((1, "truncated PNG data"), (2, "interlace method 2")):
        ihdr[20] = method
        ihdr[21:25] = zlib.crc32(bytes(ihdr[4:21])).to_bytes(4, "big")
        with pytest.raises(ValueError, match=match):
            decode_image(buf[:8] + bytes(ihdr) + buf[33:])
    for cut in (60, len(adam7) - 20):
        with pytest.raises(ValueError):
            decode_image(adam7[:cut])
    with pytest.raises(ValueError, match="CRC"):
        decode_image(buf[:40] + bytes([buf[40] ^ 1]) + buf[41:])
    for cut in (20, 45, len(buf) - 30, len(buf) - 12):
        with pytest.raises(ValueError):
            decode_image(buf[:cut])


def test_bmp_from_bytes_and_imread_rgb_without_cv2_or_pil(tmp_path, monkeypatch):
    """A machine without cv2 or PIL: imread_rgb reads JPEG, PNG and BMP
    files by their bytes (a file's extension does not decide). Bytes of no
    format the port decodes go to cv2, which gives no image for them
    (ValueError naming the file) and, where it cannot be imported, raise
    NotImplementedError naming item 11."""
    rng = np.random.default_rng(12)
    img = smooth(rng, 30, 50)
    files = {"a.jpg": cv2.imencode(".jpg", img)[1].tobytes(),
             "b.png": cv2.imencode(".png", img)[1].tobytes(),
             "c.bmp": cv2.imencode(".bmp", img)[1].tobytes(),
             "d.png": cv2.imencode(".jpg", img)[1].tobytes()}  # a JPEG named .png
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    (tmp_path / "e.jpg").write_bytes(b"no image here")
    with pytest.raises(ValueError, match="e.jpg"):
        imread_rgb(str(tmp_path / "e.jpg"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name, data in files.items():
        np.testing.assert_array_equal(imread_rgb(str(tmp_path / name)), cv2_rgb(data))
    np.testing.assert_array_equal(imread_rgb(str(tmp_path / "b.png")), img[..., ::-1])
    np.testing.assert_array_equal(codec.decode_bmp(files["c.bmp"]), img[..., ::-1])
    with pytest.raises(NotImplementedError, match="unknown format.*item 11"):
        imread_rgb(str(tmp_path / "e.jpg"))


def test_threads_decode_in_parallel_and_agree():
    """ctypes releases the GIL: eight threads decode the full-size corpus
    at once, each result equal to the serial one."""
    names = [e["file"] for e in MANIFEST if e["file"].startswith("full_")]
    datas = [open(os.path.join(FIXTURES, n), "rb").read() for n in names] * 4
    serial = [decode_image(d) for d in datas]
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(decode_image, datas))
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)
    assert isinstance(codec.jpeg_library(), ctypes.CDLL)


def test_host_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """A source that does not compile raises RuntimeError with the
    compiler's message; nothing falls back."""
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="broken.cpp") as e:
        cuda_build.build_all(["broken"])
    assert "error" in str(e.value)
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "_build"))
    assert cuda_build.sources() == ["broken"]


def test_hostile_payloads_raise_value_error_or_decode():
    """A server decodes bytes from anyone: an overfull Huffman table (which
    once wrote past the decoder's lookup table), a frame over cv2's pixel
    limit, and 1500 seeded mutations of the corpus each raise ValueError or
    decode to an RGB image, and never take the process down."""
    rng = np.random.default_rng(13)
    base = cv2.imencode(".jpg", smooth(rng, 24, 40))[1].tobytes()
    dht = base.index(b"\xff\xc4")
    # AC table 3: 7 codes of 1-7 bits, then 155 of 8 bits, far more than fit
    table = bytes([0x13, 1, 1, 1, 1, 1, 1, 1, 155] + [0] * 8) + bytes(range(162))
    overfull = base[:dht] + b"\xff\xc4" + (len(table) + 2).to_bytes(2, "big") + table + base[dht:]
    with pytest.raises(ValueError, match="bad Huffman table"):
        decode_image(overfull)
    huge = bytearray(base)
    sof = base.index(b"\xff\xc0")
    huge[sof + 5:sof + 9] = (50000).to_bytes(2, "big") + (50000).to_bytes(2, "big")
    with pytest.raises(ValueError, match="exceeds"):
        decode_image(bytes(huge))
    png = cv2.imencode(".png", smooth(rng, 8, 8))[1].tobytes()
    ihdr = bytearray(png[8:33])
    ihdr[8:16] = (40000).to_bytes(4, "big") * 2
    ihdr[21:25] = zlib.crc32(bytes(ihdr[4:21])).to_bytes(4, "big")
    with pytest.raises(ValueError, match="exceeds"):
        decode_image(png[:8] + bytes(ihdr) + png[33:])
    corpus = [open(os.path.join(FIXTURES, e["file"]), "rb").read() for e in MANIFEST
              if not e["file"].startswith("full_")]
    decoded = 0
    for _ in range(1500):
        b = bytearray(corpus[rng.integers(len(corpus))])
        for _ in range(int(rng.integers(1, 6))):
            i = int(rng.integers(min(len(b), 700)))
            b[i] = int(rng.integers(256))
        try:
            out = decode_image(bytes(b))
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
        decoded += 1
    assert 0 < decoded < 1500
