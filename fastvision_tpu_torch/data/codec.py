"""Image decoding without cv2 or PIL: the port's counterpart of
``cv2.imdecode(buf, cv2.IMREAD_COLOR)`` followed by BGR -> RGB, as the JAX
package decodes request bodies (fastvision_tpu/infer/serving.py:39-46) and
image files (fastvision_tpu/data/dataset.py:28-35).

`decode_image` picks the decoder by the payload's signature:

- JPEG (``FF D8``): ``csrc/jpeg_decode.cpp``, built with the host compiler
  and called through ctypes (which releases the GIL). Sequential and
  progressive JPEG at 8 bits, Huffman- or arithmetic-coded (SOF0-2, SOF9,
  SOF10), gray, YCbCr, RGB, CMYK and YCCK, any integral sampling, restart
  intervals, the standard Huffman tables where a sequential scan names one
  no DHT defined (Motion-JPEG frames), the Adobe transform flag and the
  EXIF orientation; lossless JPEG (SOF3, 2-8 bits: predictors 1-7, the
  point transform) where it is RGB-coded or CMYK. All bit-equal to libjpeg-turbo
  3.1's default decode as cv2 5.0 runs it (block smoothing of a
  progressive file whose scans stop early included);
- PNG, non-interlaced or Adam7-interlaced: gray, RGB, palette, gray +
  alpha and RGBA at bit depths 1-8 and 16, with numpy and the standard
  library's ``zlib``; alpha is dropped and 16 bits keep their high byte, as
  cv2's ``IMREAD_COLOR`` does;
- BMP (``BM``): uncompressed 24- and 32-bit, with numpy.

Anything else raises ``ValueError("cannot decode image payload")``; the
JPEG kinds cv2 returns no image for (12-bit, lossless above 8 bits,
YCbCr-tagged, YCCK or gray lossless, hierarchical, SOF11, a DNL marker)
and truncated or corrupt data (a bad Huffman or arithmetic code included)
raise ``ValueError`` naming what is missing. Nothing falls back to cv2. The
output is RGB uint8 HWC; grayscale is repeated to 3 channels.

The same library gives the port's counterparts of the JAX package's
``fastvision_tpu.native`` and of cv2's reduced reads:

- `decode_jpeg_reduced`: ``cv2.IMREAD_REDUCED_COLOR_{2,4,8}``, bit for bit
  (a lossless JPEG at full size: libjpeg does not scale it);
- `decode_jpeg_i420`: ``native.decode_jpeg_i420``, the fused JPEG ->
  letterboxed packed-I420 decode (bit-equal to the JAX package's build on
  the files both take), except that it applies the EXIF orientation;
- `letterbox_batch_native`: ``native.letterbox_batch`` (``csrc/letterbox.cpp``).
"""
from __future__ import annotations

import ctypes
import zlib

import numpy as np

from .. import cuda_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
MAX_PIXELS = 1 << 30  # the largest image taken: OpenCV's default CV_IO_MAX_IMAGE_PIXELS
_ERR_LEN = 256


def jpeg_library() -> ctypes.CDLL:
    """``csrc/jpeg_decode.cpp``, built on first use (raises if it cannot
    be built). Call it before forking workers, so they inherit it."""
    lib = cuda_build.load("jpeg_decode")
    if not getattr(lib, "_fv_typed", False):
        c_int, c_i64, c_ptr, c_str = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
        for fn in (lib.fvj_dims_reduced, lib.fvj_decode_reduced, lib.fvj_decode_i420_letterbox):
            fn.restype = c_int
        lib.fvj_dims_reduced.argtypes = [c_str, c_i64, c_int, ctypes.POINTER(ctypes.c_int32),
                                         c_str, c_int]
        lib.fvj_decode_reduced.argtypes = [c_str, c_i64, c_int, c_ptr, c_i64, c_str, c_int]
        lib.fvj_decode_i420_letterbox.argtypes = [
            c_str, c_i64, c_int, ctypes.c_uint8, c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_str, c_int]
        lib._fv_typed = True
    return lib


def jpeg_size(data: bytes, factor: int = 1) -> tuple[int, int]:
    """A JPEG's (height, width) as `decode_jpeg_reduced` gives it
    at 1/``factor``: EXIF orientation applied, ceil(side / factor) (a
    lossless JPEG's full size)."""
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int32 * 2)()
    if jpeg_library().fvj_dims_reduced(data, len(data), factor, dims, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return int(dims[0]), int(dims[1])


def decode_jpeg_reduced(data: bytes, factor: int = 1) -> np.ndarray:
    """A JPEG -> RGB uint8 HWC at 1/``factor`` (1, 2, 4 or 8),
    EXIF orientation applied: cv2's ``IMREAD_REDUCED_COLOR_{factor}``
    (libjpeg-turbo's scaled IDCTs and its upsampler choice), bit for bit."""
    data = bytes(data)
    h, w = jpeg_size(data, factor)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if jpeg_library().fvj_decode_reduced(data, len(data), factor, out.ctypes.data, out.nbytes,
                                         err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG -> RGB uint8 HWC, EXIF orientation applied."""
    return decode_jpeg_reduced(data, 1)


def decode_jpeg_i420(data: bytes, size: int, pad_value: int = 114, reduce_target: int = 0):
    """Fused JPEG decode -> letterboxed packed I420 [S*3/2, S] uint8, the
    port of ``fastvision_tpu.native.decode_jpeg_i420``: the file's stored
    YCbCr planes, no chroma upsampling and no RGB round trip, converted to
    cv2's studio-swing convention (what `ops.image.i420_packed_to_rgb`
    inverts) and letterboxed plane by plane with `data.dataset.letterbox`'s
    geometry. ``reduce_target`` > 0 decodes at 1/f for the largest f in
    {8, 4, 2} with max(h, w) >= f * reduce_target (``imread_rgb_scaled``'s
    rule). The EXIF orientation is applied to the planes first.

    -> (packed, scale (float32, decoded frame), (pad_left, pad_top),
    (orig_h, orig_w), (decoded_h, decoded_w)), or None where the JAX package
    falls back to its plain chain: not a JPEG, an RGB-coded JPEG, or a
    sampling other than luma (1|2) x (1|2) with 1x1 chroma, or CMYK / YCCK.
    A lossless JPEG raises ValueError, as the JAX package's (libjpeg 2.1.5)
    does, and so does a JPEG this decoder refuses (truncated, ...)."""
    if size % 2:
        raise ValueError(f"i420 needs an even input_size, got {size}")
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        return None
    out = np.empty((size * 3 // 2, size), np.uint8)
    scale = np.empty(1, np.float32)
    pads = np.empty(2, np.int32)
    dims = np.empty(4, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    # the studio-swing luma of RGB gray(pad_value); chroma pads with 128
    pad_y = int(np.clip(np.round(16 + 219 * pad_value / 255), 0, 255))
    rc = jpeg_library().fvj_decode_i420_letterbox(
        data, len(data), size, pad_y, reduce_target, out.ctypes.data,
        scale.ctypes.data, pads.ctypes.data, dims.ctypes.data, err, _ERR_LEN)
    if rc == 1:
        return None
    if rc:
        raise ValueError(err.value.decode())
    return (out, float(scale[0]), (int(pads[0]), int(pads[1])), (int(dims[0]), int(dims[1])),
            (int(dims[2]), int(dims[3])))


def letterbox_library() -> ctypes.CDLL:
    """``csrc/letterbox.cpp``, built on first use (raises if it cannot be built)."""
    lib = cuda_build.load("letterbox")
    if not getattr(lib, "_fv_typed", False):
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.letterbox_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint8, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.letterbox_batch.restype = None
        lib._fv_typed = True
    return lib


def letterbox_batch_native(images: list[np.ndarray], size: int, pad_value: int = 114,
                           num_threads: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched letterbox of HWC uint8 RGB images in ``csrc/letterbox.cpp``
    (``fastvision_tpu.native.letterbox_batch``, bit for bit). -> (batch
    [N, size, size, 3] uint8, scales [N] float32, pads [N, 2] int32 (x, y)).
    ``num_threads`` <= 0: min(cores, 8)."""
    import os

    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"expected HWC RGB uint8, got {im.shape}")
    n = len(images)
    srcs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    hs = np.asarray([im.shape[0] for im in images], np.int32)
    ws = np.asarray([im.shape[1] for im in images], np.int32)
    out = np.empty((n, size, size, 3), np.uint8)
    scales = np.empty(n, np.float32)
    pads = np.empty((n, 2), np.int32)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    letterbox_library().letterbox_batch(
        srcs, hs.ctypes.data_as(i32p), ws.ctypes.data_as(i32p), n, size, pad_value,
        out.ctypes.data, scales.ctypes.data, pads.ctypes.data, num_threads)
    return out, scales, pads


def decode_bmp(buf: bytes, name: str = "BMP payload") -> np.ndarray:
    """An uncompressed 24- or 32-bit BMP (BI_RGB, or BI_BITFIELDS with the
    BGRX masks cv2 writes) -> RGB uint8 HWC, rows bottom-up or top-down,
    each padded to 4 bytes. Anything else raises ValueError."""
    if len(buf) < 54 or buf[:2] != b"BM":
        raise ValueError(f"not a BMP file: {name}")
    offset = int.from_bytes(buf[10:14], "little")
    header = int.from_bytes(buf[14:18], "little")
    width = int.from_bytes(buf[18:22], "little", signed=True)
    height = int.from_bytes(buf[22:26], "little", signed=True)
    bpp = int.from_bytes(buf[28:30], "little")
    compression = int.from_bytes(buf[30:34], "little")
    bgrx_masks = (0x00FF0000, 0x0000FF00, 0x000000FF)
    if compression == 3 and bpp == 32 and tuple(
            int.from_bytes(buf[54 + 4 * i:58 + 4 * i], "little") for i in range(3)) == bgrx_masks:
        compression = 0  # the same bytes as BI_RGB
    if header < 40 or bpp not in (24, 32) or compression != 0 or width <= 0 or height == 0:
        raise ValueError(f"unsupported BMP (header {header}, {bpp} bpp, compression "
                         f"{compression}, {width} x {height}): {name}")
    rows, stride = abs(height), (bpp * width + 31) // 32 * 4
    if len(buf) < offset + rows * stride:
        raise ValueError(f"truncated BMP: {name}")
    px = np.frombuffer(buf, np.uint8, rows * stride, offset).reshape(rows, stride)
    px = px[:, : width * bpp // 8].reshape(rows, width, bpp // 8)[..., 2::-1]  # BGR(X) -> RGB
    return np.ascontiguousarray(px[::-1] if height > 0 else px)  # height > 0: bottom-up


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise ValueError("truncated PNG data")
        if kind[0] & 0x20 == 0 and zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            raise ValueError(f"corrupt PNG data: CRC error in a {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG data: no IEND chunk")


def _paeth_row(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        row[i] = (row[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255


def _average_row(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prior[i]) >> 1)) & 255


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone -> [height, stride] uint8. None, Sub and Up
    rows run in numpy; Average and Paeth rows, whose bytes each depend on the
    byte to their left, byte by byte."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = cur
        elif ftype == 1:  # Sub: a running sum (mod 256) over each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = cur
            out[y] = np.cumsum(lanes.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            out[y] = cur + prior
        elif ftype in (3, 4):
            row = bytearray(cur.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(row, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"corrupt PNG data: filter type {ftype}")
        prior = out[y]
    return out


# Adam7's seven passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _samples(rows: np.ndarray, width: int, channels: int, depth: int, ctype: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> uint8 samples [h, width, channels]:
    16 bits to their high byte, 1-4-bit samples unpacked MSB first (gray
    scaled to 0-255, palette indices kept)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, width, channels, 2)[..., 0]  # the high byte of each sample
    if depth == 8:
        return rows.reshape(h, width, channels)
    per_byte = 8 // depth  # 1, 2 or 4 bits, one channel
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    px = vals.reshape(h, rows.shape[1] * per_byte)[:, :width, None]
    if ctype == 0:  # gray scaled to 0-255, as libpng's expand_gray_1_2_4_to_8
        px = px * np.uint8(255 // ((1 << depth) - 1))
    return px


def decode_png(data: bytes) -> np.ndarray:
    """A PNG, non-interlaced or Adam7-interlaced (each pass unfiltered on
    its own rows, then scattered into the image) -> RGB uint8 HWC, as cv2's
    IMREAD_COLOR gives it: palette expanded, gray repeated, alpha dropped,
    16 bits to their high byte, 1-4-bit gray scaled to 0-255."""
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("corrupt PNG data: IHDR length")
            header = body
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("corrupt PNG data: no IHDR or IDAT chunk")
    width, height = int.from_bytes(header[0:4], "big"), int.from_bytes(header[4:8], "big")
    depth, ctype, interlace = header[8], header[9], header[12]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    valid_depths = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if channels is None or depth not in valid_depths or width == 0 or height == 0:
        raise ValueError(f"corrupt PNG data: colour type {ctype} at bit depth {depth}, "
                         f"{width} x {height}")
    if interlace > 1:
        raise ValueError(f"corrupt PNG data: interlace method {interlace}")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width} x {height} exceeds {MAX_PIXELS} pixels")
    bits_per_pixel = channels * depth
    bpp = max(1, bits_per_pixel // 8)
    # (first column, first row, column step, row step, columns, rows) of each
    # pass; a pass with no pixel has no filter byte either
    passes = [(0, 0, 1, 1, width, height)] if not interlace else [
        (x0, y0, dx, dy, -(-(width - x0) // dx), -(-(height - y0) // dy))
        for x0, y0, dx, dy in ADAM7 if width > x0 and height > y0]
    sizes = [ph * ((pw * bits_per_pixel + 7) // 8 + 1) for *_, pw, ph in passes]
    try:  # inflate no more than the image needs
        raw = zlib.decompressobj().decompress(b"".join(idat), sum(sizes))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from None
    if len(raw) < sum(sizes):
        raise ValueError("truncated PNG data: the image data ends early")
    px = np.empty((height, width, channels), np.uint8)
    at = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        rows = _unfilter(raw[at:at + size], ph, size // ph - 1, bpp)
        px[y0::dy, x0::dx] = _samples(rows, pw, channels, depth, ctype)
        at += size
    if ctype == 3:
        if palette is None:
            raise ValueError("corrupt PNG data: a palette image without PLTE")
        index = px[..., 0]
        if int(index.max()) >= len(palette):
            raise ValueError("corrupt PNG data: a palette index past the palette")
        return np.ascontiguousarray(palette[index])
    if channels in (1, 2):
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2))
    return np.ascontiguousarray(px[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> RGB uint8 HWC, the decoder picked by signature: JPEG,
    PNG or BMP. Anything else, or a payload its decoder refuses, raises
    ValueError."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    raise ValueError("cannot decode image payload")
