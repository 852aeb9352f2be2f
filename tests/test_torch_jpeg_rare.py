"""The port's arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG
decoding against cv2 5.0 and the JAX package, on the CPU.

Tolerance: none. Every decode is compared bit for bit with live
``cv2.imdecode(buf, IMREAD_COLOR)[..., ::-1]`` (libjpeg-turbo 3.1) on files
that `testing.encode_progressive_jpeg(arithmetic=True)` (jcarith.c's coder)
and `testing.encode_lossless_jpeg` / `testing.lossless_jpeg` write here;
the committed files of libjpeg's and GDCM's own encoders are held in
``test_torch_codec.py`` and ``test_torch_i420.py``. An arithmetic file also
decodes to the pixels of its Huffman twin (the same quantized
coefficients). The reduced decodes hold against cv2's
``IMREAD_REDUCED_COLOR_{2,4,8}`` (a lossless file's full size),
`imread_rgb_scaled` against the JAX package's, and the fused I420 decode
against ``fastvision_tpu.native.decode_jpeg_i420`` (libjpeg 2.1.5: it
decodes arithmetic files and refuses lossless ones).

Where cv2 returns no image (YCbCr-tagged, YCCK and gray lossless, 12-bit
DCT data, lossless outside 2-8 bits), the port raises ValueError saying so. Two departures are pinned:
a truncated arithmetic stream raises (cv2 returns None there too), and a
bad arithmetic code raises where libjpeg warns and cv2 returns an image.
"""
import os

import cv2
import numpy as np
import pytest

import fastvision_tpu.native as jnative
from fastvision_tpu.data import dataset as jds
from fastvision_tpu_torch import testing as T
from fastvision_tpu_torch.data import codec
from fastvision_tpu_torch.data import dataset as tds
# the JAX package's native decode, rebuilt privately where its first build lost a race
from test_torch_fast_decode import jax_native_jpeg  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_codec_fixtures")
SIZES = ((1, 1), (2, 3), (8, 8), (9, 17), (16, 16), (23, 45), (40, 33), (67, 131))
SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}
REDUCED = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}


def cv2_rgb(buf: bytes, flag: int = cv2.IMREAD_COLOR):
    bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
    return None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])


def assert_as_cv2(buf: bytes, what: str) -> np.ndarray:
    got, want = codec.decode_image(buf), cv2_rgb(buf)
    assert want is not None and got.shape == want.shape, (what, got.shape)
    assert not (got != want).any(), f"{what}: {int((got != want).sum())} bytes differ"
    return got


def read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("sampling", [*SAMPLINGS, "gray", "cmyk"])
def test_arithmetic_files_decode_as_cv2_and_as_their_huffman_twins(sampling):
    """Sequential and progressive (libjpeg's script: spectral selection and
    successive approximation) at every size of test_torch_codec.SIZES, with
    restart intervals and DAC conditioning in turn; CMYK is coded as YCCK
    (Adobe transform 2)."""
    dqt, dht = T.standard_jpeg_tables(85)
    samp = SAMPLINGS.get(sampling, (2, 2))
    for i, (h, w) in enumerate(SIZES):
        img = T.blurred_noise(h, w, 10 * i + len(sampling), ksize=3)
        if sampling == "gray":
            img = img[..., 1]
        elif sampling == "cmyk":
            img = np.concatenate([img, T.blurred_noise(h, w, 99 + i, ksize=3)[..., :1]], -1)
        for progressive in (False, True):
            kw = dict(sampling=samp, progressive=progressive, restart=(0, 1, 3)[i % 3])
            cond = ((1, 3, 9), None, (2, 5, 2))[i % 3]
            arith = T.encode_progressive_jpeg(img, dqt, dht, arithmetic=True, conditioning=cond,
                                              **kw)
            assert arith[arith.index(b"\xff\xc9" if not progressive else b"\xff\xca"):][:2] in (
                b"\xff\xc9", b"\xff\xca")
            got = assert_as_cv2(arith, f"{sampling} {h}x{w} {kw} {cond}")
            twin = codec.decode_image(T.encode_progressive_jpeg(img, dqt, dht, **kw))
            np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_decodes_as_cv2_and_pt0_is_the_source(predictor):
    """Point transforms 0 and 2, restarts every 0 / 1 / 3 rows, RGB-coded
    and CMYK, smooth and noise content, one interleaved scan or one scan per
    component: cv2's pixels; at Pt 0 the source exactly, otherwise the
    source with its low Pt bits cleared (RGB)."""
    rng = np.random.default_rng(predictor)
    for i, (h, w) in enumerate(SIZES):
        rgb = T.blurred_noise(h, w, i) if i % 2 else rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for pt in (0, 2):
            rst = (0, 1, 3)[(i + pt) % 3]
            got = assert_as_cv2(T.encode_lossless_jpeg(rgb, predictor, pt, rst), f"{h}x{w} pt {pt}")
            np.testing.assert_array_equal(got, rgb >> pt << pt)
            split = T.lossless_jpeg(T.lossless_differences(rgb, predictor, pt, rst), predictor, pt,
                                    rst, interleaved=False)
            np.testing.assert_array_equal(assert_as_cv2(split, f"{h}x{w} a scan a component"), got)
        cmyk = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        assert_as_cv2(T.encode_lossless_jpeg(cmyk, predictor, i % 3, i % 2, cmyk=True),
                      f"CMYK {h}x{w}")


def test_lossless_differences_wrap_as_libjpeg():
    """Streams of seeded differences that no image gives (categories 0-16,
    16 meaning 32768) at 2-8 bits: the predictions wrap at 16 bits and the
    output keeps the low 8 bits of sample << Pt, as libjpeg's do; a file
    without the Adobe marker is RGB in lossless mode."""
    rng = np.random.default_rng(0)
    for t in range(24):
        h, w = (int(v) for v in rng.integers(1, 24, 2))
        cat = rng.integers(0, 17, (h, w, 3))
        mag = (1 << np.maximum(cat - 1, 0)) + rng.integers(0, 1 << 15, (h, w, 3)) % (
            1 << np.maximum(cat - 1, 0))
        signed = mag * rng.choice([-1, 1], (h, w, 3))
        diffs = np.where(cat == 0, 0, np.where(cat == 16, 32768, signed))
        precision = int(rng.integers(2, 9))
        buf = T.lossless_jpeg(diffs, int(rng.integers(1, 8)), int(rng.integers(0, precision)),
                              int(rng.integers(0, 3)), markers=bool(t % 2), precision=precision)
        assert_as_cv2(buf, f"stream {t} at {precision} bits")
    # no marker and components 1, 2, 3: RGB in lossless mode (YCbCr in a DCT file)
    src = T.blurred_noise(14, 22, 3)
    buf = bytearray(T.encode_lossless_jpeg(src, 2))
    buf = buf[:2] + buf[4 + int.from_bytes(buf[4:6], "big"):]  # the Adobe segment out
    for marker, first, step in ((b"\xff\xc3", 10, 3), (b"\xff\xda", 5, 2)):
        at = bytes(buf).index(marker)
        for k in range(3):
            buf[at + first + step * k] = k + 1
    np.testing.assert_array_equal(assert_as_cv2(bytes(buf), "ids 1, 2, 3"), src)


def test_lossless_below_8_bits_decodes_as_cv2():
    """Lossless files of 2-7-bit samples (no writer here but the test's own
    makes them; GDCM's refuses): libjpeg-turbo 3.1's 8-bit API returns the
    samples unscaled, and so does the port; 1 and 9 bits give cv2 no image
    and raise."""
    for precision in range(2, 8):
        src = T.blurred_noise(17, 26, precision) >> (8 - precision)
        for predictor, pt in ((1, 0), (7, 1), (4, precision - 1)):
            got = assert_as_cv2(T.encode_lossless_jpeg(src, predictor, pt, precision % 3,
                                                       precision=precision), f"{precision} bits")
            np.testing.assert_array_equal(got, src >> pt << pt)
    for precision in (1, 9):
        buf = T.lossless_jpeg(np.zeros((4, 5, 3), np.int64), 1, precision=precision)
        assert cv2_rgb(buf) is None
        with pytest.raises(ValueError, match=f"{precision}-bit lossless JPEG") as e:
            codec.decode_image(buf)
        assert "cv2 5.0 returns no image for it either" in str(e.value)


def test_kinds_cv2_refuses_raise():
    """YCbCr-tagged (JFIF), YCCK and gray lossless files, 12-bit DCT and 12-
    and 16-bit lossless (GDCM's encoders): cv2 returns None, and the port
    raises saying so; a lossless file without DHT is refused by both
    (libjpeg installs the standard tables for the sequential DCT decoder
    only)."""
    for name, match in (("lossless_ycbcr_p1_21x30.jpg", "lossless YCbCr"),
                        ("lossless_ycck_p1_17x23.jpg", "lossless YCCK"),
                        ("lossless_gray_p1_19x26.jpg", "lossless gray"),
                        ("sof1_12bit_20x30.jpg", "12-bit JPEG"),
                        ("lossless_12bit_rgb_16x20.jpg", "12-bit lossless"),
                        ("lossless_16bit_rgb_16x20.jpg", "16-bit lossless")):
        data = read(name)
        assert cv2_rgb(data) is None, name
        for fn in (codec.decode_image, lambda d: codec.decode_jpeg_reduced(d, 2), codec.jpeg_size):
            with pytest.raises(ValueError, match=match) as e:
                fn(data)
            assert "cv2 5.0 returns no image for it either" in str(e.value)
    small = T.blurred_noise(12, 20, 1)
    coded = T.lossless_jpeg(T.lossless_differences(small, 1, 4), 1, 4)
    at = coded.index(b"\xff\xc4")
    bare = coded[:at] + coded[at + 2 + int.from_bytes(coded[at + 2:at + 4], "big"):]
    assert cv2_rgb(bare) is None
    with pytest.raises(ValueError, match="undefined Huffman table"):
        codec.decode_image(bare)


def test_reduced_decodes_equal_cv2():
    """1/2, 1/4, 1/8 of arithmetic files (libjpeg's scaled IDCTs on the same
    coefficients) and of lossless ones, which cv2 returns at full size."""
    dqt, dht = T.standard_jpeg_tables(90)
    img = T.blurred_noise(133, 201, 4)
    files = [T.encode_progressive_jpeg(img, dqt, dht, sampling=s, progressive=p, arithmetic=True,
                                       restart=5)
             for s, p in (((2, 2), False), ((2, 1), True), ((1, 1), True))]
    files += [T.encode_lossless_jpeg(img, 4, 1, 7), read("lossless_rgb_p4_samp22_31x45.jpg"),
              read("lossless_cmyk_p1_21x30.jpg")]
    for k, data in enumerate(files):
        lossless = k >= 3
        for f, flag in REDUCED.items():
            want = cv2_rgb(data, flag)
            got = codec.decode_jpeg_reduced(data, f)
            np.testing.assert_array_equal(got, want)
            assert codec.jpeg_size(data, f) == want.shape[:2]
            if lossless:
                np.testing.assert_array_equal(got, codec.decode_image(data))


def test_imread_rgb_scaled_equals_jax(tmp_path):
    """The reduced read of a file on disk: an arithmetic file at 1/2 - 1/8,
    a lossless one at full size (with its full size reported), as the JAX
    package's cv2.imread(IMREAD_REDUCED_COLOR_*) reads them."""
    dqt, dht = T.standard_jpeg_tables(90)
    img = T.blurred_noise(150, 220, 5)
    for name, data in (("a.jpg", T.encode_progressive_jpeg(img, dqt, dht, arithmetic=True)),
                       ("b.jpg", T.encode_progressive_jpeg(img, dqt, dht, arithmetic=True,
                                                           progressive=False, restart=4)),
                       ("c.jpg", T.encode_lossless_jpeg(img, 7, 0, 9))):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        for target in (16, 30, 60, 100, 400):
            got, orig = tds.imread_rgb_scaled(path, target)
            want, jorig = jds.imread_rgb_scaled(path, target)
            np.testing.assert_array_equal(got, want)
            assert tuple(orig) == tuple(jorig) == (150, 220)


def _fused(fn, data, size, target):
    try:
        r = fn(data, size, 114, reduce_target=target)
    except ValueError:
        return "raises"
    if r is None:
        return None
    packed, scale, pads, orig, dec = r
    return packed.tobytes(), float(np.float32(scale)), tuple(pads), tuple(orig), tuple(dec)


def test_fused_decode_bit_equal_to_jax_native(jax_native_jpeg):
    """Arithmetic files (4:2:0, 4:2:2, 4:4:0, gray; sequential and
    progressive, restarts) at sizes 416 / 64 / 32 and every reduce target;
    lossless files raise ValueError in both packages."""
    dqt, dht = T.standard_jpeg_tables(90)
    for i, (h, w, samp) in enumerate(((250, 377, (2, 2)), (130, 97, (2, 1)), (71, 140, (1, 2)),
                                      (90, 64, None))):
        img = T.blurred_noise(h, w, 20 + i)
        for progressive in (False, True):
            data = T.encode_progressive_jpeg(img if samp else img[..., 0], dqt, dht,
                                             sampling=samp or (1, 1), progressive=progressive,
                                             arithmetic=True, restart=3 * i)
            m = max(h, w)
            for size in (416, 64, 32):
                for target in sorted({m // f for f in (8, 4, 2)} | {0}):
                    want = _fused(jnative.decode_jpeg_i420, data, size, target)
                    assert want not in (None, "raises")
                    got = _fused(codec.decode_jpeg_i420, data, size, target)
                    assert got == want, (i, size, target)
    for data in (T.encode_lossless_jpeg(T.blurred_noise(40, 60, 3), 1),
                 read("lossless_rgb_p1_37x53.jpg"), read("lossless_cmyk_p1_21x30.jpg")):
        for fn in (jnative.decode_jpeg_i420, codec.decode_jpeg_i420):
            with pytest.raises(ValueError):
                fn(data, 64, 114)


def test_arithmetic_smoothing_departure_pinned(jax_native_jpeg):
    """As test_torch_i420.test_smoothing_departure_pinned, on arithmetic
    files: a script stopping at Al = 1 decodes as cv2's libjpeg-turbo 3.1
    (block smoothing) and the JAX package's fused decode (libjpeg 2.1.5)
    differs from the port's, while on the complete script of the same
    coefficients both fused decodes are bit-equal."""
    dqt, dht = T.standard_jpeg_tables(85)
    scene = T._scene(47, 66, 230)
    al1 = T.encode_progressive_jpeg(scene, dqt, dht, script="al1", arithmetic=True)
    full = T.encode_progressive_jpeg(scene, dqt, dht, arithmetic=True)
    assert_as_cv2(al1, "al1")
    for data, differs in ((al1, True), (full, False)):
        port = _fused(codec.decode_jpeg_i420, data, 64, 0)
        assert (port != _fused(jnative.decode_jpeg_i420, data, 64, 0)) == differs
    np.testing.assert_array_equal(assert_as_cv2(full, "full"), codec.decode_image(
        T.encode_progressive_jpeg(scene, dqt, dht)))


def test_truncated_and_bad_code_streams_pinned(tmp_path):
    """Corrupt arithmetic data, route by route. A stream cut anywhere in its
    entropy-coded data without an EOI raises on the memory route (jdarith.c
    cannot suspend; cv2.imdecode returns None) and decodes on the file route
    as cv2.imread does (the stdio source's fake EOI: zeros from there on);
    the same cut followed by EOI decodes as cv2 decodes it, restarts
    included (a missing restart marker is resynchronized). A bad arithmetic
    code decodes as libjpeg recovers from it: the rest of the restart
    interval is left zero."""
    dqt, dht = T.standard_jpeg_tables(90)
    for restart in (0, 2):
        data = T.encode_progressive_jpeg(T.blurred_noise(48, 64, 7), dqt, dht, progressive=False,
                                         arithmetic=True, restart=restart)
        sos = data.index(b"\xff\xda")
        for cut in (sos + 30, len(data) // 2, len(data) - 10, len(data) - 2):
            assert cv2_rgb(data[:cut]) is None
            with pytest.raises(ValueError, match="truncated"):
                codec.decode_image(data[:cut])
            assert_as_cv2(data[:cut] + b"\xff\xd9", f"cut at {cut} + EOI")
            path = str(tmp_path / f"cut{restart}_{cut}.jpg")
            with open(path, "wb") as f:
                f.write(data[:cut])
            np.testing.assert_array_equal(tds.imread_rgb(path), cv2.imread(path)[..., ::-1])
    truncated = read("arith_truncated.jpg")
    assert cv2_rgb(truncated) is None
    with pytest.raises(ValueError, match="truncated"):
        codec.decode_image(truncated)
    assert_as_cv2(read("arith_bad_code.jpg"), "a bad arithmetic code")
