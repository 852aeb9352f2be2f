"""Image decoding: the port's counterpart of ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)`` and ``cv2.imread(path, cv2.IMREAD_COLOR)`` followed by
BGR -> RGB, as the JAX package decodes request bodies
(fastvision_tpu/infer/serving.py:39-46) and image files
(fastvision_tpu/data/dataset.py:28-35).

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
  cv2's ``IMREAD_COLOR`` does, and an eXIf chunk's orientation applied;
- BMP (``BM``): every kind cv2's decoder reads (`decode_bmp`), with numpy;
- anything else (WebP, TIFF, AVIF, JPEG 2000, GIF, PNM, ...) goes to cv2
  where it imports (`cv2_decode`), else raises NotImplementedError naming
  the format and ROADMAP Queue 1 item 11.

A JPEG is decoded by the end-of-data rules of its route (`ROUTES`): on
the memory route a truncated stream raises, as cv2.imdecode returns None;
on the file and fused routes it decodes as libjpeg decodes it after its
source's fake EOI. Corrupt data is recovered from as libjpeg does on every
route (a bad Huffman code reads as symbol 0, a bad arithmetic code leaves
the rest of the restart interval zero, a restart marker out of place goes
through jpeg_resync_to_restart). The JPEG kinds cv2 returns no image for
(12-bit, lossless above 8 bits, YCbCr-tagged, YCCK or gray lossless,
hierarchical, SOF11) and what cv2 gives no image for on a route raise
``ValueError`` naming what is missing; those errors never go to cv2. The
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
ITEM = "(ROADMAP Queue 1, item 11)"

# A JPEG's end-of-data rules on each route the JAX package decodes by
# (csrc/jpeg_decode.cpp's Decoder): "memory" is cv2.imdecode (OpenCV's own
# source suspends where libjpeg asks for a byte past the end of the buffer,
# and cv2 returns no image: a missing EOI fails unless a one-pass scan's
# last fill happened to stop at the end); "file" is cv2.imread (libjpeg's
# stdio source reads a fake EOI at the end: the scan in hand is finished from
# zero bits, as at a marker met inside the data, and what the scans read is
# decoded); "fused" is the JAX package's native.decode_jpeg_i420 (jpeg_mem_src's
# fake EOI, and the markers after a one-pass scan are read to the EOI, as its
# jpeg_finish_decompress reads them, where cv2 ignores them).
ROUTES = ("memory", "file", "fused")


def _route_code(route: str) -> int:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    return ROUTES.index(route)


def jpeg_library() -> ctypes.CDLL:
    """``csrc/jpeg_decode.cpp``, built on first use (raises if it cannot
    be built). Call it before forking workers, so they inherit it."""
    lib = cuda_build.load("jpeg_decode")
    if not getattr(lib, "_fv_typed", False):
        c_int, c_i64, c_ptr, c_str = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
        for fn in (lib.fvj_dims_reduced, lib.fvj_decode_reduced, lib.fvj_decode_i420_letterbox):
            fn.restype = c_int
        lib.fvj_dims_reduced.argtypes = [c_str, c_i64, c_int, c_int,
                                         ctypes.POINTER(ctypes.c_int32), c_str, c_int]
        lib.fvj_decode_reduced.argtypes = [c_str, c_i64, c_int, c_int, c_ptr, c_i64, c_str, c_int]
        lib.fvj_decode_i420_letterbox.argtypes = [
            c_str, c_i64, c_int, c_int, ctypes.c_uint8, c_int, c_ptr, c_ptr, c_ptr, c_ptr, c_str,
            c_int]
        lib._fv_typed = True
    return lib


def jpeg_size(data: bytes, factor: int = 1) -> tuple[int, int]:
    """A JPEG's (height, width) as `decode_jpeg_reduced` gives it
    at 1/``factor``: EXIF orientation applied, ceil(side / factor) (a
    lossless JPEG's full size)."""
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = (ctypes.c_int32 * 2)()
    if jpeg_library().fvj_dims_reduced(data, len(data), _route_code("file"), factor, dims, err,
                                       _ERR_LEN):
        raise ValueError(err.value.decode())
    return int(dims[0]), int(dims[1])


def decode_jpeg_reduced(data: bytes, factor: int = 1, route: str = "file") -> np.ndarray:
    """A JPEG -> RGB uint8 HWC at 1/``factor`` (1, 2, 4 or 8),
    EXIF orientation applied: cv2's ``IMREAD_REDUCED_COLOR_{factor}``
    (libjpeg-turbo's scaled IDCTs and its upsampler choice), bit for bit.
    ``route``: the end-of-data rule (`ROUTES`); "file" reads a file's bytes
    as ``cv2.imread`` does."""
    data = bytes(data)
    h, w = jpeg_size(data, factor)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if jpeg_library().fvj_decode_reduced(data, len(data), _route_code(route), factor,
                                         out.ctypes.data, out.nbytes, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def decode_jpeg(data: bytes, route: str = "memory") -> np.ndarray:
    """A JPEG -> RGB uint8 HWC, EXIF orientation applied, by ``route``'s
    end-of-data rule (`ROUTES`)."""
    return decode_jpeg_reduced(data, 1, route)


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
    The "fused" route's end-of-data rules (`ROUTES`): a truncated file
    decodes as the JAX package's ``jpeg_mem_src`` decodes it. A lossless
    JPEG raises ValueError, as the JAX package's (libjpeg 2.1.5) does, and
    so does what libjpeg refuses (a frame marker after a one-pass scan
    included: its jpeg_finish_decompress reads on to the EOI)."""
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
        data, len(data), _route_code("fused"), size, pad_y, reduce_target, out.ctypes.data,
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


def _bmp_pixels_rle(buf: bytes, pos: int, width: int, height: int, bits: int) -> np.ndarray | None:
    """RLE8 / RLE4 pixel data -> palette indices [height, width] in stored
    row order, as cv2's BmpDecoder walks them, or None where it gives no
    image (a run or an absolute block past its row's end, data that ends
    before the last row). End-of-line, delta (dx + dy rows, in raster order)
    and end-of-bitmap fill what they pass over with entry 0; in RLE4 the
    end of bitmap is read as an end of line and a delta's dy is dropped, as
    cv2 reads them. An RLE8 run that fills its row moves on to the next row,
    and an end-of-line right after it is then skipped; an RLE4 run, and an
    absolute block, stay at their row's end until an escape moves on."""
    out = np.zeros((height, width), np.uint8)  # entry 0 wherever nothing is written
    y = x = 0
    run_ended_row = False
    n = len(buf)
    while y < height:
        if pos + 2 > n:
            return None
        count, code = buf[pos], buf[pos + 1]
        pos += 2
        if count:  # encoded: one index (RLE4: two, alternating)
            if x + count > width:
                return None
            out[y, x:x + count] = code if bits == 8 else np.resize([code >> 4, code & 15], count)
            x += count
            run_ended_row = bits == 8 and x == width
            if run_ended_row:
                y, x = y + 1, 0
            continue
        if code > 2:  # absolute: `code` indices, padded to 2 bytes
            size = ((code + 1) // 2 if bits == 4 else code) + 1 & ~1
            if x + code > width or pos + size > n:
                return None
            raw = np.frombuffer(buf, np.uint8, size, pos)
            if bits == 4:
                raw = np.stack([raw >> 4, raw & 15], 1).reshape(-1)
            out[y, x:x + code] = raw[:code]
            x, pos = x + code, pos + size
            continue
        # 0 end of line, 1 end of bitmap, 2 delta: pass over `skip` pixels
        # (RLE4: the end of bitmap is an end of line, a delta moves dx only)
        skip = width - x
        if code == 1 and bits == 8:
            skip += (height - y) * width
        elif code == 2:
            if pos + 2 > n:
                return None
            skip = buf[pos] + (buf[pos + 1] * width if bits == 8 else 0)
            pos += 2
        if code or not run_ended_row or skip < width:
            y, x = divmod(y * width + x + skip, width)  # a row's end counts as the next row's start
        run_ended_row = False
    return out


def decode_bmp(buf: bytes, name: str = "BMP payload") -> np.ndarray:
    """A BMP -> RGB uint8 HWC as cv2's BmpDecoder reads it under
    IMREAD_COLOR: the OS/2 core header (12 bytes) or any header of at least
    36 (BITMAPINFOHEADER, V4, V5); 1-, 4- and 8-bit palette images (RLE4 and
    RLE8 included), 16-bit 555 (BI_RGB, or BI_BITFIELDS with its masks) and
    565 (BI_BITFIELDS), 24-bit, and 32-bit: BGRX, or BI_BITFIELDS through
    the red, green and blue masks of a header of 56 bytes or more where
    none is 0 (`_bmp_masked`). A 16-bit file's masks are the three DWORDs
    after the header, where cv2 reads them, whatever the header holds. 5-
    and 6-bit fields are shifted up, not replicated, as cv2's converters
    do. Rows bottom-up or top-down, each padded to 4 bytes. What cv2
    returns no image for raises ValueError."""
    def refuse(why: str):
        raise ValueError(f"{why}: {name}")

    if len(buf) < 18 or buf[:2] != b"BM":
        refuse("not a BMP file")
    u16 = lambda at: int.from_bytes(buf[at:at + 2], "little")  # noqa: E731
    u32 = lambda at: int.from_bytes(buf[at:at + 4], "little")  # noqa: E731
    i32 = lambda at: int.from_bytes(buf[at:at + 4], "little", signed=True)  # noqa: E731
    offset, header = u32(10), i32(14)
    if header >= 36:
        if len(buf) < 14 + header:
            refuse("truncated BMP")
        width, height, bpp, compression, used = i32(18), i32(22), u16(28), u32(30), i32(46)
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 16, 24, 32) and compression == 0)
            or (bpp in (16, 32) and compression == 3)
            or (bpp == 4 and compression == 2) or (bpp == 8 and compression == 1))
        entry, after = 4, 14 + header
        if bpp == 16 and compression == 0:
            bpp = 15
    elif header == 12:
        if len(buf) < 26:
            refuse("truncated BMP")
        width, height, bpp, compression, used = u16(18), u16(20), u16(24), 0, 0  # WORDs
        ok = width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)
        entry, after = 3, 26
    else:
        ok = False
    if not ok:
        refuse(f"unsupported BMP (header {header})")
    palette = np.zeros((256, 3), np.uint8)
    if bpp <= 8:
        if not 0 <= used <= 256:
            refuse(f"unsupported BMP (a palette of {used} entries)")
        count = used or 1 << bpp
        if len(buf) < after + count * entry:
            refuse("truncated BMP")
        palette[:count] = np.frombuffer(buf, np.uint8, count * entry, after).reshape(
            count, entry)[:, 2::-1]  # BGR(A) -> RGB
    elif bpp == 16:
        if len(buf) < after + 12:
            refuse("truncated BMP")
        masks = (u32(after), u32(after + 4), u32(after + 8))  # red, green, blue
        if masks == (0x7C00, 0x3E0, 0x1F):
            bpp = 15
        elif masks != (0xF800, 0x7E0, 0x1F):
            refuse(f"unsupported BMP (16-bit masks {masks})")
    rows = abs(height)
    if width * rows > MAX_PIXELS:
        refuse(f"BMP of {width} x {rows} exceeds {MAX_PIXELS} pixels")
    if compression in (1, 2):
        index = _bmp_pixels_rle(buf, offset, width, rows, bpp)
        if index is None:
            refuse("corrupt BMP data: an RLE run overruns its row or the data ends early")
        px = palette[index]
    else:
        stride = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        if len(buf) < offset + rows * stride:
            refuse("truncated BMP")
        raw = np.frombuffer(buf, np.uint8, rows * stride, offset).reshape(rows, stride)
        if bpp <= 8:
            shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
            idx = ((raw[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(rows, -1)[:, :width]
            px = palette[idx]
        elif bpp in (15, 16):
            v = raw[:, :2 * width].reshape(rows, width, 2).astype(np.uint16)
            v = v[..., 0] | (v[..., 1] << 8)
            if bpp == 15:
                r, g = (v >> 7) & 0xF8, (v >> 2) & 0xF8
            else:
                r, g = (v >> 8) & 0xF8, (v >> 3) & 0xFC
            px = np.stack([r, g, (v << 3) & 0xF8], -1).astype(np.uint8)
        else:
            px = raw[:, :width * bpp // 8].reshape(rows, width, bpp // 8)[..., 2::-1]
            masks = [u32(54 + 4 * i) for i in range(3)] if header >= 56 and compression == 3 else []
            if masks and all(masks):
                px = _bmp_masked(raw[:, :4 * width].reshape(rows, width, 4), masks)
    return np.ascontiguousarray(px[::-1] if height > 0 else px)  # height > 0: bottom-up


def _bmp_masked(px: np.ndarray, masks: list[int]) -> np.ndarray:
    """32-bit pixels [h, w, 4] (little-endian) through a V3 - V5 header's
    red, green and blue masks, as cv2 5.0 scales each field: the field
    shifted down, times 255 / (mask shifted down) in float32, truncated."""
    value = px.view("<u4")[..., 0].astype(np.uint64)
    out = []
    for m in masks:
        shift = (m & -m).bit_length() - 1
        field = ((value & m) >> shift).astype(np.float32)
        out.append((field * (np.float32(255) / np.float32(m >> shift))).astype(np.uint8))
    return np.stack(out, -1)


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise ValueError("truncated PNG data")
        if zlib.crc32(kind + body) == int.from_bytes(crc, "big"):
            yield kind, body
        elif kind[0] & 0x20 == 0:  # libpng drops an ancillary chunk whose CRC fails
            raise ValueError(f"corrupt PNG data: CRC error in a {kind.decode('latin-1')} chunk")
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


def exif_orientation(tiff: bytes) -> int:
    """The orientation (1-8) in EXIF's TIFF structure (either byte order,
    IFD0 tag 0x0112 of type SHORT), else 1: what cv2's ExifReader gives
    ``ApplyExifOrientation``."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    order = "little" if tiff[:2] == b"II" else "big"
    u16 = lambda at: int.from_bytes(tiff[at:at + 2], order)  # noqa: E731
    if u16(2) != 42:
        return 1
    ifd = int.from_bytes(tiff[4:8], order)
    if ifd + 2 > len(tiff):
        return 1
    for i in range(u16(ifd)):
        e = ifd + 2 + 12 * i
        if e + 12 > len(tiff):
            return 1
        if u16(e) == 0x0112 and u16(e + 2) == 3:
            o = u16(e + 8)
            return o if 1 <= o <= 8 else 1
    return 1


def orient(image: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation: 2 flips left-right, 3 turns half way, 4
    flips upside down; 5-8 transpose first, then 6 flips left-right, 7
    turns half way, 8 flips upside down."""
    if orientation >= 5:
        image = image.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(image, flip) if flip else image)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG, non-interlaced or Adam7-interlaced (each pass unfiltered on
    its own rows, then scattered into the image) -> RGB uint8 HWC, as cv2's
    IMREAD_COLOR gives it: palette expanded, gray repeated, alpha dropped,
    16 bits to their high byte, 1-4-bit gray scaled to 0-255, and an eXIf
    chunk's orientation applied, before the image data or after it (cv2 5.0
    honours both; libpng drops one whose CRC fails or that does not start
    with a TIFF byte order)."""
    header, palette, idat, exif = None, None, [], None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("corrupt PNG data: IHDR length")
            header = body
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and exif is None and body[:2] in (b"II", b"MM"):
            exif = body  # (libpng keeps the first valid one)
    if header is None or not idat:
        raise ValueError("corrupt PNG data: no IHDR or IDAT chunk")
    orientation = exif_orientation(exif or b"")
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
        return orient(palette[index], orientation)
    if channels in (1, 2):
        return orient(np.repeat(px[..., :1], 3, axis=2), orientation)
    return orient(px[..., :3], orientation)


# (signature, its offset, format): how a payload names its format
_SIGNATURES = ((b"\xff\xd8", 0, "JPEG"), (PNG_SIGNATURE, 0, "PNG"), (b"BM", 0, "BMP"),
               (b"WEBP", 8, "WebP"), (b"II*\x00", 0, "TIFF"), (b"MM\x00*", 0, "TIFF"),
               (b"GIF8", 0, "GIF"), (b"ftypavi", 4, "AVIF"), (b"ftyphei", 4, "HEIF"),
               (b"ftypmif1", 4, "HEIF"), (b"\x00\x00\x00\x0cjP  ", 0, "JPEG 2000"),
               (b"\xffO\xffQ", 0, "JPEG 2000"), (b"#?RADIANCE", 0, "Radiance HDR"),
               (b"#?RGBE", 0, "Radiance HDR"), (b"\x59\xa6\x6a\x95", 0, "Sun raster"),
               (b"v/1\x01", 0, "OpenEXR"), (b"Pf", 0, "PFM"), (b"PF", 0, "PFM"))


def image_format(data: bytes) -> str:
    """The format a payload's signature names ("JPEG", "PNG", "BMP", "WebP",
    "TIFF", ...; "PNM" for P1-P7), or "unknown"."""
    data = bytes(data[:16])
    for sig, at, name in _SIGNATURES:
        if data[at:at + len(sig)] == sig and (name != "WebP" or data[:4] == b"RIFF"):
            return name
    return "PNM" if data[:1] == b"P" and data[1:2] in b"1234567" and len(data) > 1 else "unknown"


def cv2_decode(data: bytes, path: str | None = None) -> np.ndarray:
    """A payload the port has no decoder for, through cv2 as the JAX package
    reads it: ``cv2.imread(path)`` where the bytes came from a file, else
    ``cv2.imdecode``; then BGR -> RGB. cv2's None raises ValueError; without
    cv2 this raises NotImplementedError naming the format."""
    try:
        import cv2
    except ImportError:
        kind = image_format(data)
        kind = "images of an unknown format" if kind == "unknown" else f"{kind} images"
        raise NotImplementedError(
            f"{kind} are decoded through cv2, which cannot be imported; the port decodes "
            f"JPEG, PNG and BMP itself {ITEM}") from None
    if path is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
    else:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) if data else None
    if img is None:
        raise ValueError("cannot decode image payload")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def decode_image(data: bytes, path: str | None = None) -> np.ndarray:
    """Image bytes -> RGB uint8 HWC, as cv2 decodes them under IMREAD_COLOR:
    ``cv2.imdecode`` (the memory route), or, where ``path`` names the file
    the bytes were read from, ``cv2.imread(path)`` (the file route: a JPEG's
    end reads as an EOI marker, `ROUTES`). JPEG, PNG and BMP go to the
    port's decoders, which raise ValueError where cv2 returns no image
    (their errors never go to cv2); any other payload goes to cv2
    (`cv2_decode`)."""
    data = bytes(data)
    kind = image_format(data)
    if kind == "JPEG":
        return decode_jpeg(data, "memory" if path is None else "file")
    if kind == "PNG":
        return decode_png(data)
    if kind == "BMP":
        return decode_bmp(data, path or "BMP payload")
    return cv2_decode(data, path)
