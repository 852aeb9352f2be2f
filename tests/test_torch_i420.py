"""The port's native host code against its oracles, on the CPU: the fused
JPEG -> letterboxed I420 decode (`codec.decode_jpeg_i420`) against the JAX
package's ``fastvision_tpu.native.decode_jpeg_i420``, the reduced RGB decode
(`codec.decode_jpeg_reduced`) against cv2's ``IMREAD_REDUCED_COLOR_{2,4,8}``,
the native letterbox (`codec.letterbox_batch_native`) against
``fastvision_tpu.native.letterbox_batch``, and `jpeg_dimensions`.

Every comparison is bit-equal (bytes, scale, pads, dims), on every JPEG of
`tests/torch_codec_fixtures` that both take, at sizes 416 / 64 / 32 and at
the reduce targets that give factors 1 / 2 / 4 / 8, and on files encoded
here; where the JAX package's fused decode raises (lossless JPEG, which its
libjpeg 2.1.5 refuses) the port's raises too. Where the port departs on
purpose (ROADMAP Queue 3), a test pins the departure: the port applies the EXIF orientation on the fused path (the JAX
package's ignores it) and reports the oriented original size from the
reduced decode (the JAX package's ``imread_rgb_scaled`` reports the SOF's);
on a progressive file whose scans stop early (block smoothing) the port
smooths as libjpeg-turbo 3.1 does (cv2 5.0's), the JAX package's fused
decode as the host's libjpeg does (2.1.5 here, whose smoothing differs).

The card's machine has neither cv2 nor the JAX package: the oracles'
digests are stored in ``tests/torch_codec_fixtures/native_oracles.json``
(listed in its ``manifest.json``), which `chip_smoke.py` reads; here they
are regenerated and must equal the stored ones. Rewrite them with
``PYTHONPATH=. python tests/test_torch_i420.py --write`` (needs cv2 and the JAX
package's native build).
"""
import hashlib
import json
import os
import sys

import cv2
import numpy as np
import pytest

from fastvision_tpu import native
from fastvision_tpu.data import dataset as jds
from fastvision_tpu_torch.data import codec
from fastvision_tpu_torch.data import dataset as tds
from test_torch_fast_decode import jax_native_jpeg  # noqa: F401 (a fixture)

# the JAX package's native build races on a cold temporary directory (a
# worker that loses keeps the letterbox-only library): the fixture builds it
# again, privately, where that happened
pytestmark = pytest.mark.usefixtures("jax_native_jpeg")

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_codec_fixtures")
ORACLES = os.path.join(FIXTURES, "native_oracles.json")
SIZES = (416, 64, 32)
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
JPEGS = [e["file"] for e in MANIFEST["files"] if e["file"].endswith(".jpg") and "raises" not in e]
# the files the JAX package's fused decode reads in the stored frame: EXIF
# orientation 1 or none (it ignores the tag; the port applies it)
# progressive files whose scans leave coefficients short of full precision:
# libjpeg block-smooths them, and 2.1.5 (the JAX package's native build here)
# smooths otherwise than 3.1 (cv2's, which the port follows)
SMOOTHED = ("prog_own_al1.jpg", "prog_cv2_dc_only.jpg")
UNROTATED = [f for f in JPEGS if not (f.startswith("exif_orientation_") and f != "exif_orientation_1.jpg")
             and f not in SMOOTHED]
CV2_REDUCED = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
               8: cv2.IMREAD_REDUCED_COLOR_8}


def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def reduce_targets(data: bytes) -> list[int]:
    """Reduce targets that make the fused decode pick factors 8, 4, 2 and 1."""
    m = max(codec.jpeg_size(data))
    return sorted({max(m // f, 0) for f in (8, 4, 2)} | {0})


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _fused(fn, data, size, target):
    r = fn(data, size, 114, reduce_target=target)
    if r is None:
        return None
    packed, scale, pads, orig, dec = r
    return {"sha256": _digest(packed), "scale": float(np.float32(scale)), "pads": list(pads),
            "orig_hw": list(orig), "decoded_hw": list(dec)}


def _fused_or_raise(fn, data, size, target):
    """`_fused`, or {"raises": True} where ``fn`` raises ValueError (the
    JAX package's libjpeg 2.1.5 refuses lossless JPEG)."""
    try:
        return _fused(fn, data, size, target)
    except ValueError:
        return {"raises": True}


def live_oracles() -> dict:
    """The oracles, regenerated: the JAX package's fused decode of every
    unrotated corpus JPEG at each size and reduce target (the files it
    refuses listed apart), and cv2's reduced RGB decode of every corpus
    JPEG at 1/2, 1/4, 1/8 (a lossless file's full size)."""
    i420, refused = [], []
    for name in UNROTATED:
        data = _read(name)
        for size in SIZES:
            for target in reduce_targets(data):
                r = _fused_or_raise(native.decode_jpeg_i420, data, size, target)
                if r == {"raises": True}:
                    refused.append({"file": name, "size": size, "reduce_target": target})
                elif r is not None:
                    i420.append({"file": name, "size": size, "reduce_target": target, **r})
    reduced = []
    for name in JPEGS:
        for f, flag in CV2_REDUCED.items():
            rgb = cv2.imdecode(np.frombuffer(_read(name), np.uint8), flag)[..., ::-1]
            reduced.append({"file": name, "factor": f, "shape": list(rgb.shape),
                            "sha256": _digest(rgb)})
    return {"i420_pad_value": 114, "fused_i420": i420, "fused_i420_raises": refused,
            "cv2_reduced": reduced}


def test_stored_oracles_equal_live_ones():
    with open(ORACLES) as f:
        assert json.load(f) == live_oracles()
    assert MANIFEST["oracles"]["file"] == os.path.basename(ORACLES)


@pytest.mark.parametrize("name", UNROTATED)
def test_fused_i420_bit_equal_to_jax_native(name):
    data = _read(name)
    for size in SIZES:
        for target in reduce_targets(data):
            want = _fused_or_raise(native.decode_jpeg_i420, data, size, target)
            if want is None:  # the JAX package falls back: so must the port
                assert codec.decode_jpeg_i420(data, size, 114, target) is None, (size, target)
                continue
            got = _fused_or_raise(codec.decode_jpeg_i420, data, size, target)
            assert got == want, (size, target)


@pytest.mark.parametrize("name", JPEGS)
def test_reduced_decode_bit_equal_to_cv2(name):
    data = _read(name)
    for f, flag in CV2_REDUCED.items():
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)[..., ::-1]
        np.testing.assert_array_equal(codec.decode_jpeg_reduced(data, f), want)
        assert codec.jpeg_size(data, f) == want.shape[:2]


def _encode(rng, h, w, samp, quality=90, restart=0):
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def test_fresh_encodes_bit_equal():
    """Larger, odd-sized files at each sampling: every reduce factor on
    both oracles, the luma of 4:2:2 / 4:4:0 chroma at its own IDCT size."""
    rng = np.random.default_rng(0)
    for h, w, samp in ((333, 517, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                       (517, 301, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                       (250, 377, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                       (129, 257, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)):
        data = _encode(rng, h, w, samp, restart=3)
        for target in (0, 30, 64, 100, 200):
            for size in (416, 98):
                assert (_fused(codec.decode_jpeg_i420, data, size, target)
                        == _fused(native.decode_jpeg_i420, data, size, target))
        for f, flag in CV2_REDUCED.items():
            np.testing.assert_array_equal(codec.decode_jpeg_reduced(data, f),
                                          cv2.imdecode(np.frombuffer(data, np.uint8), flag)[..., ::-1])


def test_native_letterbox_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((480, 640), (37, 53), (416, 416), (1, 9), (300, 199), (17, 1000))]
    for size in (416, 64, 97):
        for threads in (1, 3):
            got = codec.letterbox_batch_native(imgs, size, 114, num_threads=threads)
            want = native.letterbox_batch(imgs, size, 114, num_threads=threads)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        codec.letterbox_batch_native([np.zeros((4, 4), np.uint8)], 8)


def test_jpeg_dimensions_match_jax(tmp_path):
    for name in JPEGS + ["png_rgb8.png"]:
        path = os.path.join(FIXTURES, name)
        assert tds.jpeg_dimensions(path) == jds.jpeg_dimensions(path), name
    short = tmp_path / "short.jpg"
    short.write_bytes(_read("full_480x640.jpg")[:40])
    assert tds.jpeg_dimensions(str(short)) == jds.jpeg_dimensions(str(short))


def test_fallbacks_and_errors():
    """None where the JAX package falls back (not a JPEG, an RGB-coded
    JPEG, 4:1:1, CMYK and YCCK); ValueError where the port's decoder
    refuses; progressive and truncated files decode as the JAX package's do."""
    for name in ("png_rgb8.png", "adobe_transform_0.jpg", "component_ids_rgb.jpg",
                 "cv2_411_q75_58x97_6.jpg", "cmyk_pil.jpg", "cmyk_pil_progressive.jpg",
                 "ycck_own.jpg", "ycck_own_progressive.jpg"):
        assert codec.decode_jpeg_i420(_read(name), 64) is None, name
        if name.endswith(".jpg"):
            assert native.decode_jpeg_i420(_read(name), 64) is None, name
    for name in ("progressive.jpg", "prog_pil_422.jpg", "tableless_cv2_420.jpg",
                 "truncated.jpg"):  # (cut: jpeg_mem_src's fake EOI, as the file route's)
        assert _fused(codec.decode_jpeg_i420, _read(name), 64, 0) == \
            _fused(native.decode_jpeg_i420, _read(name), 64, 0), name
    with pytest.raises(ValueError, match="undefined Huffman table"):
        codec.decode_jpeg_i420(_read("tableless_progressive.jpg"), 64)
    with pytest.raises(ValueError, match="even"):
        codec.decode_jpeg_i420(_read("full_480x640.jpg"), 63)


@pytest.mark.parametrize("orientation", [6, 8])
def test_exif_departures_pinned(orientation, tmp_path):
    """On a phone photo turned by EXIF: the JAX package's imread_rgb_scaled
    returns the SOF size beside a turned image, and its fused decode ignores
    the tag; the port's both paths agree on the turned frame."""
    name = f"exif_orientation_{orientation}.jpg"
    data, path = _read(name), os.path.join(FIXTURES, name)
    sof = jds.jpeg_dimensions(path)  # (37, 53): landscape as stored
    img, orig = jds.imread_rgb_scaled(path, 10)  # decoded at 1/4
    assert orig == sof and img.shape[:2] == (14, 10)  # axes mixed up in the JAX package
    timg, torig = tds.imread_rgb_scaled(path, 10)
    assert torig == (53, 37) and timg.shape[:2] == (14, 10)
    np.testing.assert_array_equal(timg, img)  # the pixels are cv2's
    size = 64
    jax_i420 = native.decode_jpeg_i420(data, size, 114)
    assert jax_i420[2] == (0, 9) and jax_i420[3] == sof  # landscape geometry
    packed, scale, pads, orig_hw, dec_hw = codec.decode_jpeg_i420(data, size, 114)
    assert orig_hw == dec_hw == (53, 37) and pads == (9, 0)  # portrait, as the RGB path
    rgb = codec.decode_jpeg(data)
    lb, lscale, lpads = tds.letterbox(rgb, size)
    assert rgb.shape[:2] == (53, 37) and lpads == pads and np.float32(lscale) == np.float32(scale)
    from fastvision_tpu_torch.ops.image import i420_packed_to_rgb
    import torch

    back = i420_packed_to_rgb(torch.from_numpy(packed[None])).numpy()[0]
    # the same picture: the I420 round trip of a 4:2:0 JPEG, within its chroma error
    assert np.abs(back - lb.astype(np.float32)).mean() < 6.0
    # the JAX decode is the port's of the same file without its EXIF segment
    bare = data[:2] + data[4 + int.from_bytes(data[4:6], "big"):]
    assert data[2:4] == b"\xff\xe1" and bare[2:4] != b"\xff\xe1"
    np.testing.assert_array_equal(codec.decode_jpeg_i420(bare, size, 114)[0], jax_i420[0])


def test_smoothing_departure_pinned():
    """A script stopping at Al = 1 and one with DC scans only: the port's
    RGB decode is cv2's (libjpeg-turbo 3.1) and its fused decode smooths
    the same planes; the JAX package's fused decode differs (its libjpeg
    smooths otherwise) while on the complete script of the same
    coefficients (prog_own_full.jpg) both fused decodes are bit-equal."""
    for name in SMOOTHED:
        data = _read(name)
        np.testing.assert_array_equal(codec.decode_image(data), cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
        assert _fused(codec.decode_jpeg_i420, data, 64, 0) != _fused(native.decode_jpeg_i420, data, 64, 0)
    full = _read("prog_own_full.jpg")
    assert _fused(codec.decode_jpeg_i420, full, 64, 0) == _fused(native.decode_jpeg_i420, full, 64, 0)


if __name__ == "__main__" and "--write" in sys.argv:
    with open(ORACLES, "w") as f:
        json.dump(live_oracles(), f, indent=0)
    print(f"wrote {ORACLES}")
