"""Writes the MPEG-4 Part 2 video fixtures of ``tests/torch_video_fixtures/``
and their ``manifest.json`` (not collected by pytest: run it by hand).

    python tests/make_torch_video_fixtures.py

It needs cv2 (5.x, with its bundled FFmpeg) and the system FFmpeg 5.1
libraries (``libavcodec.so.59``, ``libavformat.so.59``, ``libavutil.so.57``,
reached through ctypes; the struct offsets below are theirs on x86-64).
cv2's ``VideoWriter`` writes the I/P files (``XVID`` / ``DIVX`` AVIs, an
``mp4v`` MP4 and MOV); the system libraries write the rest: ``libxvid``
with B-VOPs (an XviD-tagged stream), FFmpeg's ``mpeg4`` encoder with
B-VOPs, 4MV, quarter-pel, MPEG quantisation with loaded matrices, adaptive
quantisation (``dquant``), AC prediction, resync packets, data
partitioning and interlacing (field DCT and prediction, alternate scan),
``libxvid`` with GMC (S-VOPs, 3 warping points), and an MP4 with B-VOPs
(its ``ctts`` and ``elst``). Three files are made from others: a copy whose
user data names an XviD build (FFmpeg then decodes it with the XviD IDCT),
an AVI with N-VOP chunks inserted, and a GMC stream whose warps are made
translations.

The manifest holds, per fixture: the per-frame SHA-256 of the Y, Cb and Cr
planes that libavcodec 59 decodes (display order), checked against the Y
plane cv2's ``VideoCapture`` gives with ``CAP_PROP_CONVERT_RGB`` 0 (both
FFmpeg builds must agree); cv2's frame count and fps; the frame every
``set(CAP_PROP_POS_FRAMES, i); read()`` lands on, from a fresh capture, for
i in 0 .. count + 1; the port's RGB against cv2's frames; the port's
decoder's counts of the stream's tools, which confirm each feature listed
as written. Where cv2 gives no image (it refuses interlaced frames), only
its frame count and fps are kept.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_video_fixtures")

# --- FFmpeg 5.1 (libavcodec 59, libavformat 59, libavutil 57) on x86-64 ---
CTX_TIME_BASE, CTX_WIDTH, CTX_HEIGHT, CTX_PIX_FMT = 100, 116, 120, 136
CTX_FLAGS, CTX_INTRA_MATRIX, CTX_INTER_MATRIX, CTX_THREADS = 76, 272, 280, 636
CTX_FRAMERATE, CTX_CODEC_TAG = 712, 28
FRAME_DATA, FRAME_LINESIZE, FRAME_WIDTH, FRAME_HEIGHT, FRAME_FORMAT, FRAME_PTS = \
    0, 64, 104, 108, 116, 136
PKT_PTS, PKT_DTS, PKT_DATA, PKT_SIZE, PKT_STREAM, PKT_FLAGS = 8, 16, 24, 32, 36, 40
FMT_PB, FMT_STREAMS = 32, 48
ST_TIME_BASE, ST_AVG_RATE, ST_CODECPAR = 16, 72, 208
PAR_CODEC_TAG = 8
YUV420P, GLOBAL_HEADER, AVIO_WRITE, SEARCH_CHILDREN = 0, 1 << 22, 2, 1
EAGAIN, EOF = -11, -541478725


class Rational(ctypes.Structure):
    _fields_ = [("num", ctypes.c_int), ("den", ctypes.c_int)]


def _libs():
    avutil = ctypes.CDLL("libavutil.so.57")
    avcodec = ctypes.CDLL("libavcodec.so.59")
    avformat = ctypes.CDLL("libavformat.so.59")
    avutil.av_log_set_level(16)  # errors only
    vp = ctypes.c_void_p
    for lib, name, res, args in [
        (avcodec, "avcodec_find_encoder_by_name", vp, [ctypes.c_char_p]),
        (avcodec, "avcodec_find_decoder", vp, [ctypes.c_int]),
        (avcodec, "avcodec_alloc_context3", vp, [vp]),
        (avcodec, "avcodec_open2", ctypes.c_int, [vp, vp, vp]),
        (avcodec, "avcodec_send_frame", ctypes.c_int, [vp, vp]),
        (avcodec, "avcodec_receive_packet", ctypes.c_int, [vp, vp]),
        (avcodec, "avcodec_send_packet", ctypes.c_int, [vp, vp]),
        (avcodec, "avcodec_receive_frame", ctypes.c_int, [vp, vp]),
        (avcodec, "avcodec_free_context", None, [vp]),
        (avcodec, "avcodec_parameters_from_context", ctypes.c_int, [vp, vp]),
        (avcodec, "avcodec_parameters_to_context", ctypes.c_int, [vp, vp]),
        (avcodec, "av_packet_alloc", vp, []),
        (avcodec, "av_packet_free", None, [vp]),
        (avcodec, "av_packet_unref", None, [vp]),
        (avcodec, "av_packet_rescale_ts", None, [vp, Rational, Rational]),
        (avutil, "av_frame_alloc", vp, []),
        (avutil, "av_frame_free", None, [vp]),
        (avutil, "av_frame_get_buffer", ctypes.c_int, [vp, ctypes.c_int]),
        (avutil, "av_frame_make_writable", ctypes.c_int, [vp]),
        (avutil, "av_opt_set", ctypes.c_int, [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
        (avutil, "av_malloc", vp, [ctypes.c_size_t]),
        (avformat, "avformat_alloc_output_context2", ctypes.c_int,
         [vp, vp, ctypes.c_char_p, ctypes.c_char_p]),
        (avformat, "avformat_new_stream", vp, [vp, vp]),
        (avformat, "avio_open", ctypes.c_int, [vp, ctypes.c_char_p, ctypes.c_int]),
        (avformat, "avio_closep", ctypes.c_int, [vp]),
        (avformat, "avformat_write_header", ctypes.c_int, [vp, vp]),
        (avformat, "av_interleaved_write_frame", ctypes.c_int, [vp, vp]),
        (avformat, "av_write_trailer", ctypes.c_int, [vp]),
        (avformat, "avformat_free_context", None, [vp]),
        (avformat, "avformat_open_input", ctypes.c_int, [vp, ctypes.c_char_p, vp, vp]),
        (avformat, "avformat_find_stream_info", ctypes.c_int, [vp, vp]),
        (avformat, "av_find_best_stream", ctypes.c_int,
         [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, ctypes.c_int]),
        (avformat, "av_read_frame", ctypes.c_int, [vp, vp]),
        (avformat, "avformat_close_input", None, [vp]),
    ]:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return avutil, avcodec, avformat


AVUTIL, AVCODEC, AVFORMAT = _libs()


def _i32(addr: int, value: int | None = None) -> int:
    v = ctypes.c_int.from_address(addr)
    if value is not None:
        v.value = value
    return v.value


def _i64(addr: int, value: int | None = None) -> int:
    v = ctypes.c_int64.from_address(addr)
    if value is not None:
        v.value = value
    return v.value


def _ptr(addr: int) -> int:
    return ctypes.c_void_p.from_address(addr).value or 0


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise RuntimeError(f"{what} failed: {rc}")
    return rc


# --- content: seeded, smooth moving scenes ---------------------------------

def scene(n: int, w: int, h: int, seed: int) -> list[np.ndarray]:
    """``n`` BGR frames: a drifting low-frequency background and moving,
    textured ellipses at sub-pixel speeds, one entering half-way (intra
    macroblocks in predicted VOPs); every frame differs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 6.28, 6)
    objs = []
    for k in range(5):
        objs.append(dict(c=rng.uniform([0, 0], [w, h]), v=rng.uniform(-2.6, 2.6, 2),
                         r=rng.uniform(0.08, 0.2, 2) * [w, h], col=rng.uniform(30, 225, 3),
                         f=rng.uniform(0.05, 0.3), start=0 if k < 4 else n // 2))
    frames = []
    for i in range(n):
        t = float(i)
        img = np.empty((h, w, 3), np.float32)
        for ch in range(3):
            img[..., ch] = 128 + 60 * np.sin(xx / (23 + 7 * ch) + 0.11 * t + phase[ch]) \
                * np.cos(yy / (31 - 5 * ch) - 0.07 * t + phase[3 + ch])
        for o in objs:
            if i < o["start"]:
                continue
            cx, cy = o["c"] + o["v"] * t
            cx, cy = cx % (w + 40) - 20, cy % (h + 40) - 20
            d = ((xx - cx) / o["r"][0]) ** 2 + ((yy - cy) / o["r"][1]) ** 2
            m = np.clip(1.5 - d, 0, 1)[..., None]
            tex = 0.5 + 0.5 * np.sin((xx - cx) * o["f"] + (yy - cy) * o["f"] * 0.7)[..., None]
            img = img * (1 - m) + m * (o["col"] * (0.6 + 0.4 * tex))
        frames.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return frames


def bgr_to_yuv420(bgr: np.ndarray) -> tuple[np.ndarray, ...]:
    """BT.601 limited range, chroma the mean of each 2 x 2 (the encoders'
    input; its exact form does not matter, only that it is fixed)."""
    b, g, r = (bgr[..., i].astype(np.float32) for i in range(3))
    y = 16 + 0.2568 * r + 0.5041 * g + 0.0979 * b
    cb = 128 - 0.1482 * r - 0.2910 * g + 0.4392 * b
    cr = 128 + 0.4392 * r - 0.3678 * g - 0.0714 * b
    h, w = y.shape
    sub = [c[:h - h % 2, :w - w % 2].reshape(h // 2, 2, w // 2, 2).mean((1, 3)) for c in (cb, cr)]
    return tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, *sub))


# --- writers ----------------------------------------------------------------

def write_cv2(path: str, fourcc: str, fps: float, frames: list[np.ndarray]) -> None:
    import cv2
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} to {path}")
    for f in frames:
        wr.write(f)
    wr.release()


def write_lib(path: str, fmt: str, encoder: str, tag: str | None, fps: int,
              frames: list[np.ndarray], opts: dict[str, str], flags: str = "",
              matrices: tuple[list[int], list[int]] | None = None,
              muxer_opts: dict[str, str] | None = None) -> None:
    """``frames`` through libavcodec 59's ``encoder`` with ``opts`` (set by
    name), muxed by libavformat 59 as ``fmt`` with the FourCC ``tag`` and
    the muxer's ``muxer_opts`` (``movflags``, ...)."""
    h, w = frames[0].shape[:2]
    codec = AVCODEC.avcodec_find_encoder_by_name(encoder.encode())
    if not codec:
        raise RuntimeError(f"no {encoder} encoder")
    oc = ctypes.c_void_p()
    _check(AVFORMAT.avformat_alloc_output_context2(ctypes.byref(oc), None, fmt.encode(),
                                                   path.encode()), "output context")
    ctx = AVCODEC.avcodec_alloc_context3(codec)
    _i32(ctx + CTX_WIDTH, w)
    _i32(ctx + CTX_HEIGHT, h)
    _i32(ctx + CTX_PIX_FMT, YUV420P)
    _i32(ctx + CTX_TIME_BASE, 1)
    _i32(ctx + CTX_TIME_BASE + 4, fps)
    _i32(ctx + CTX_FRAMERATE, fps)
    _i32(ctx + CTX_FRAMERATE + 4, 1)
    _i32(ctx + CTX_THREADS, 1)
    if fmt in ("mp4", "mov"):
        _i32(ctx + CTX_FLAGS, _i32(ctx + CTX_FLAGS) | GLOBAL_HEADER)
    if flags:
        _check(AVUTIL.av_opt_set(ctx, b"flags", flags.encode(), 0), f"flags {flags}")
    for k, v in opts.items():
        _check(AVUTIL.av_opt_set(ctx, k.encode(), v.encode(), SEARCH_CHILDREN), f"option {k}")
    if matrices:
        for off, m in zip((CTX_INTRA_MATRIX, CTX_INTER_MATRIX), matrices):
            buf = AVUTIL.av_malloc(128)
            (ctypes.c_uint16 * 64).from_address(buf)[:] = m
            ctypes.c_void_p.from_address(ctx + off).value = buf
    _check(AVCODEC.avcodec_open2(ctx, codec, None), f"open {encoder}")
    st = AVFORMAT.avformat_new_stream(oc, None)
    par = _ptr(st + ST_CODECPAR)
    _check(AVCODEC.avcodec_parameters_from_context(par, ctx), "parameters")
    if tag:
        _i32(par + PAR_CODEC_TAG, struct.unpack("<I", tag.encode())[0])
    _i32(st + ST_TIME_BASE, 1)
    _i32(st + ST_TIME_BASE + 4, fps)
    _i32(st + ST_AVG_RATE, fps)
    _i32(st + ST_AVG_RATE + 4, 1)
    for k, v in (muxer_opts or {}).items():
        _check(AVUTIL.av_opt_set(oc, k.encode(), v.encode(), SEARCH_CHILDREN), f"muxer option {k}")
    _check(AVFORMAT.avio_open(oc.value + FMT_PB, path.encode(), AVIO_WRITE), "avio_open")
    _check(AVFORMAT.avformat_write_header(oc, None), "write header")
    st_tb = Rational(_i32(st + ST_TIME_BASE), _i32(st + ST_TIME_BASE + 4))
    enc_tb = Rational(1, fps)
    frame = AVUTIL.av_frame_alloc()
    _i32(frame + FRAME_WIDTH, w)
    _i32(frame + FRAME_HEIGHT, h)
    _i32(frame + FRAME_FORMAT, YUV420P)
    _check(AVUTIL.av_frame_get_buffer(frame, 0), "frame buffer")
    pkt = AVCODEC.av_packet_alloc()

    def drain():
        while True:
            rc = AVCODEC.avcodec_receive_packet(ctx, pkt)
            if rc in (EAGAIN, EOF):
                return
            _check(rc, "receive packet")
            AVCODEC.av_packet_rescale_ts(pkt, enc_tb, st_tb)
            _i32(pkt + PKT_STREAM, 0)
            _check(AVFORMAT.av_interleaved_write_frame(oc, pkt), "write frame")

    for i, bgr in enumerate(frames):
        _check(AVUTIL.av_frame_make_writable(frame), "writable")
        for p, plane in enumerate(bgr_to_yuv420(bgr)):
            data, ls = _ptr(frame + FRAME_DATA + 8 * p), _i32(frame + FRAME_LINESIZE + 4 * p)
            for row in range(plane.shape[0]):
                ctypes.memmove(data + row * ls, plane[row].ctypes.data, plane.shape[1])
        _i64(frame + FRAME_PTS, i)
        _check(AVCODEC.avcodec_send_frame(ctx, frame), "send frame")
        drain()
    _check(AVCODEC.avcodec_send_frame(ctx, None), "flush")
    drain()
    _check(AVFORMAT.av_write_trailer(oc), "trailer")
    AVFORMAT.avio_closep(oc.value + FMT_PB)
    AVFORMAT.avformat_free_context(oc)
    AVCODEC.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    AVUTIL.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
    AVCODEC.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))


# --- oracles ----------------------------------------------------------------

def decode_lib(path: str) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Every frame libavcodec 59 decodes from ``path`` (one thread), in
    display order, as (Y, Cb, Cr) planes."""
    ic = ctypes.c_void_p()
    _check(AVFORMAT.avformat_open_input(ctypes.byref(ic), path.encode(), None, None), "open")
    _check(AVFORMAT.avformat_find_stream_info(ic, None), "stream info")
    idx = _check(AVFORMAT.av_find_best_stream(ic, 0, -1, -1, None, 0), "video stream")
    st = _ptr(_ptr(ic.value + FMT_STREAMS) + 8 * idx)
    par = _ptr(st + ST_CODECPAR)
    codec_id = _i32(par + 4)
    dec = AVCODEC.avcodec_find_decoder(codec_id)
    ctx = AVCODEC.avcodec_alloc_context3(dec)
    _check(AVCODEC.avcodec_parameters_to_context(ctx, par), "to context")
    _i32(ctx + CTX_THREADS, 1)
    _check(AVCODEC.avcodec_open2(ctx, dec, None), "open decoder")
    pkt, frame = AVCODEC.av_packet_alloc(), AVUTIL.av_frame_alloc()
    out = []

    def receive():
        while True:
            rc = AVCODEC.avcodec_receive_frame(ctx, frame)
            if rc in (EAGAIN, EOF):
                return
            _check(rc, "receive frame")
            w, h = _i32(frame + FRAME_WIDTH), _i32(frame + FRAME_HEIGHT)
            planes = []
            for p, (pw, ph) in enumerate([(w, h), ((w + 1) // 2, (h + 1) // 2)] + [
                    ((w + 1) // 2, (h + 1) // 2)]):
                data, ls = _ptr(frame + FRAME_DATA + 8 * p), _i32(frame + FRAME_LINESIZE + 4 * p)
                buf = (ctypes.c_uint8 * (ls * ph)).from_address(data)
                planes.append(np.frombuffer(buf, np.uint8).reshape(ph, ls)[:, :pw].copy())
            out.append(tuple(planes))

    while AVFORMAT.av_read_frame(ic, pkt) >= 0:
        if _i32(pkt + PKT_STREAM) == idx:
            _check(AVCODEC.avcodec_send_packet(ctx, pkt), "send packet")
            receive()
        AVCODEC.av_packet_unref(pkt)
    AVCODEC.avcodec_send_packet(ctx, None)
    receive()
    AVCODEC.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    AVFORMAT.avformat_close_input(ctypes.byref(ic))
    return out


def cv2_oracle(path: str, ys: list[np.ndarray]) -> dict:
    """cv2's frame count, fps, read loop and seek landings on ``path``, each
    frame identified by its Y plane among ``ys`` (libavcodec 59's)."""
    import cv2
    keys = {}
    for i, y in enumerate(ys):
        keys.setdefault(hashlib.sha256(y.tobytes()).hexdigest(), i)

    def cap():
        c = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
        c.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        return c

    def which(ok_frame):
        ok, f = ok_frame
        if not ok:
            return None
        y = np.ascontiguousarray(f.reshape(-1)[:ys[0].size].reshape(ys[0].shape))
        k = hashlib.sha256(y.tobytes()).hexdigest()
        if k not in keys:
            raise RuntimeError(f"{path}: cv2 decoded a frame libavcodec 59 did not")
        return keys[k]

    c = cap()
    count, fps = int(c.get(cv2.CAP_PROP_FRAME_COUNT)), float(c.get(cv2.CAP_PROP_FPS))
    walk = []
    while True:
        got = which(c.read())
        if got is None:
            break
        walk.append(got)
    landings = []
    for i in range(count + 2):
        c = cap()
        c.set(cv2.CAP_PROP_POS_FRAMES, i)
        landings.append(which(c.read()))
    c = cap()
    ascending = []
    for i in range(count + 2):
        c.set(cv2.CAP_PROP_POS_FRAMES, i)
        ascending.append(which(c.read()))
    return dict(frame_count=count, fps=fps, walk=walk, landings=landings,
                landings_ascending=ascending)


def rgb_bound(path: str) -> dict:
    """cv2's BGR frames against the port's RGB decode of the same file:
    max and mean absolute difference (filled in by the port's reader)."""
    import cv2
    sys.path.insert(0, os.path.dirname(HERE))
    from fastvision_tpu_torch.data.avi import open_video
    c = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    reader = open_video(path)
    diffs = []
    for ours in reader.frames():
        ok, bgr = c.read()
        if not ok:
            break
        diffs.append(np.abs(ours.astype(np.int16) - bgr[..., ::-1].astype(np.int16)))
    d = np.stack(diffs)
    return dict(max=int(d.max()), mean=float(d.mean()))


# --- the set ----------------------------------------------------------------

def insert_nvops(src: str, dst: str, after: tuple[int, ...]) -> None:
    """``src`` (an I/P AVI written by cv2) with a not-coded P-VOP chunk
    (``vop_coded`` 0) inserted after each frame in ``after``; the stream
    header's and ``avih``'s frame counts, ``idx1`` and the sizes follow."""
    data = bytearray(open(src, "rb").read())
    movi = data.find(b"movi") - 8
    idx1 = data.find(b"idx1", movi)
    msize = struct.unpack_from("<I", data, movi + 4)[0]
    chunks, pos = [], movi + 12
    while pos < movi + 8 + msize:
        fcc, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        chunks.append((bytes(fcc), bytes(data[pos + 8:pos + 8 + size])))
        pos += 8 + size + (size & 1)
    # the VOL's time increment bits, from vop_time_increment_resolution
    vol = data.find(b"\x00\x00\x01\x20")
    res = _vol_resolution(bytes(data[vol:vol + 64]))
    bits = max(1, (res - 1).bit_length())
    # vop_coding_type P, modulo_time_base 0, marker, vop_time_increment 0,
    # marker, vop_coded 0, then next_start_code()'s stuffing
    nvop_bits = "01" + "0" + "1" + "0" * bits + "1" + "0"
    nvop_bits += "0" + "1" * (-(len(nvop_bits) + 1) % 8)
    nvop = b"\x00\x00\x01\xb6" + int(nvop_bits, 2).to_bytes(len(nvop_bits) // 8, "big")
    out_chunks = []
    for k, (fcc, body) in enumerate(chunks):
        out_chunks.append((fcc, body, 0x10 if body[:4] == b"\x00\x00\x01\xb0" else 0))
        if k in after:
            out_chunks.append((fcc, nvop, 0))
    movi_body = b"movi"
    entries = b""
    for fcc, body, flags in out_chunks:
        entries += fcc + struct.pack("<III", flags, len(movi_body), len(body))
        movi_body += fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)
    head = bytes(data[12:movi])
    n_frames = len(out_chunks)
    strh = head.find(b"strh")
    head = head[:strh + 8 + 32] + struct.pack("<I", n_frames) + head[strh + 8 + 36:]
    avih = head.find(b"avih")
    head = head[:avih + 8 + 16] + struct.pack("<I", n_frames) + head[avih + 8 + 20:]
    body = head + b"LIST" + struct.pack("<I", len(movi_body)) + movi_body \
        + b"idx1" + struct.pack("<I", len(entries)) + entries
    with open(dst, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body)
    del idx1


def _vol_resolution(vol: bytes) -> int:
    """vop_time_increment_resolution of a VOL header (no VOL ID fields
    skipped beyond what FFmpeg's encoders write)."""
    bits = "".join(format(b, "08b") for b in vol[4:])
    p = 1 + 8  # random_accessible_vol, video_object_type_indication
    if bits[p] == "1":  # is_object_layer_identifier
        p += 1 + 4 + 3
    else:
        p += 1
    ar = int(bits[p:p + 4], 2)
    p += 4
    if ar == 15:
        p += 16
    if bits[p] == "1":  # vol_control_parameters
        p += 1 + 2 + 1
        if bits[p] == "1":
            p += 1 + 79
        else:
            p += 1
    else:
        p += 1
    p += 2 + 1  # shape, marker
    return int(bits[p:p + 16], 2)


def rewrite_user_data(src: str, dst: str, old: bytes, new: bytes) -> None:
    data = open(src, "rb").read()
    assert len(old) == len(new) and data.count(old) > 0
    with open(dst, "wb") as f:
        f.write(data.replace(old, new))


# a loaded intra and inter matrix (zigzag not applied: natural order)
INTRA_MATRIX = [8 + (r + c) * 3 + (r * c) % 5 for r in range(8) for c in range(8)]
INTER_MATRIX = [16 + (r + c) * 2 + (r ^ c) % 3 for r in range(8) for c in range(8)]


def fixtures() -> list[dict]:
    """name, writer and the features each fixture holds (each checked
    against the port's decoder's count of it, `FEATURE_STATS`)."""
    return [
        dict(name="xvid_cv2_320x240.avi",
             make=lambda p: write_cv2(p, "XVID", 25, scene(72, 320, 240, 1)),
             features=["I", "P", "Lavc", "simple IDCT"]),
        dict(name="mp4v_cv2_640x480.mp4",
             make=lambda p: write_cv2(p, "mp4v", 25, scene(32, 640, 480, 2)),
             features=["I", "P", "Lavc", "mp4"]),
        dict(name="mp4v_cv2_200x136.mov",
             make=lambda p: write_cv2(p, "mp4v", 30, scene(20, 200, 136, 3)),
             features=["I", "P", "mov", "cropped"]),
        dict(name="divx_cv2_176x144.avi",
             make=lambda p: write_cv2(p, "DIVX", 25, scene(14, 176, 144, 4)),
             features=["I", "P", "DIVX"]),
        dict(name="libxvid_qpel_bframes_176x144.avi",
             make=lambda p: write_lib(p, "avi", "libxvid", "XVID", 25, scene(36, 176, 144, 5),
                                      {"bf": "2", "g": "12", "b": "300k", "lumi_aq": "1"},
                                      flags="+qpel+mv4"),
             features=["I", "P", "B", "XviD", "xvid IDCT", "packed", "qpel", "4MV", "dquant",
                       "AC pred"]),
        dict(name="lavc_bframes_184x120.avi",
             make=lambda p: write_lib(p, "avi", "mpeg4", "FMP4", 25, scene(30, 184, 120, 6),
                                      {"bf": "2", "g": "12", "b": "250k"}),
             features=["I", "P", "B", "FMP4", "cropped"]),
        dict(name="lavc_qpel_mv4_176x144.avi",
             make=lambda p: write_lib(p, "avi", "mpeg4", "DX50", 25, scene(30, 176, 144, 7),
                                      {"bf": "2", "g": "12", "b": "300k"}, flags="+mv4+qpel"),
             features=["I", "P", "B", "4MV", "qpel", "DX50"]),
        dict(name="lavc_mpegquant_resync_176x144.avi",
             make=lambda p: write_lib(p, "avi", "mpeg4", "XVID", 25, scene(26, 176, 144, 8),
                                      {"bf": "1", "g": "10", "b": "200k", "mpeg_quant": "1",
                                       "ps": "300", "lumi_mask": "0.3", "p_mask": "0.3",
                                       "mpv_flags": "+qp_rd", "mbd": "2"},
                                      flags="+mv4+aic", matrices=(INTRA_MATRIX, INTER_MATRIX)),
             features=["I", "P", "B", "MPEG quant", "loaded matrices", "resync", "dquant",
                       "AC pred", "4MV"]),
        dict(name="lavc_bframes_ctts.mp4",
             make=lambda p: write_lib(p, "mp4", "mpeg4", None, 24, scene(28, 160, 96, 9),
                                      {"bf": "2", "g": "12", "b": "200k"}),
             features=["I", "P", "B", "mp4", "ctts", "elst"]),
        dict(name="xvidtag_qpel_mv4_176x144.avi",
             make=lambda p: rewrite_user_data(os.path.join(OUT, "lavc_qpel_mv4_176x144.avi"), p,
                                              b"Lavc59.37.100", b"XviD0067_____"),
             features=["I", "P", "B", "4MV", "qpel", "XviD user data", "xvid IDCT"]),
        dict(name="lavc_datapart_176x144.avi",
             make=lambda p: write_lib(p, "avi", "mpeg4", "FMP4", 25, scene(24, 176, 144, 11),
                                      {"bf": "2", "g": "12", "b": "250k",
                                       "data_partitioning": "1", "ps": "300"},
                                      flags="+mv4+aic"),
             features=["I", "P", "B", "data partitioning", "resync", "4MV", "AC pred"]),
        dict(name="lavc_interlaced_240x160.avi",
             make=lambda p: write_lib(p, "avi", "mpeg4", "XVID", 25, scene(24, 240, 160, 12),
                                      {"bf": "2", "g": "12", "b": "300k", "alternate_scan": "1"},
                                      flags="+ildct+ilme+qpel+mv4"),
             features=["I", "P", "B", "interlaced", "field MBs", "alternate scan", "qpel",
                       "4MV"],
             # cv2 5.0's swscale refuses interlaced frames ("Cannot convert
             # interlaced to progressive"): its reads give no image to compare
             cv2_frames=False),
        dict(name="libxvid_gmc_qpel_176x144.avi",
             make=lambda p: write_lib(p, "avi", "libxvid", "XVID", 25, scene(12, 176, 144, 3),
                                      {"bf": "2", "g": "12", "b": "300k", "gmc": "1"},
                                      flags="+qpel+mv4"),
             features=["I", "P", "B", "S", "GMC", "GMC affine", "packed", "qpel", "xvid IDCT"]),
        dict(name="gmc_translation_176x144.avi",
             make=lambda p: _gmc_translation_fixture(p),
             features=["I", "P", "S", "GMC", "GMC translation", "xvid IDCT"]),
        dict(name="nvop_cv2_96x64.avi",
             make=lambda p: _nvop_fixture(p),
             features=["I", "P", "N-VOP"]),
    ]


# each feature that the port's decoder counts -> its `mpeg4.STATS` key
FEATURE_STATS = {"B": "b_vops", "4MV": "inter4v_mbs", "qpel": "quarter_pel",
                 "MPEG quant": "mpeg_quant", "loaded matrices": "loaded_inter_matrix",
                 "resync": "video_packets", "dquant": "dquant_mbs", "AC pred": "ac_pred_mbs",
                 "xvid IDCT": "xvid_idct", "packed": "packed_b_vops", "N-VOP": "n_vops",
                 "interlaced": "interlaced", "field MBs": "field_mbs",
                 "data partitioning": "partitioned_vops", "alternate scan": "alternate_scan_vops",
                 "GMC": "gmc_mbs", "GMC affine": "gmc_affine_vops",
                 "GMC translation": "gmc_translation_vops"}


# the sprite trajectory's dmv_length VLC (canonical codes from these lengths)
_TRAJ_LENS = [2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]


def _traj_codes() -> dict:
    codes, code = {}, 0
    for i, n in enumerate(_TRAJ_LENS):
        if i:
            code = (code + 1) << (n - _TRAJ_LENS[i - 1])
        codes[format(code, f"0{n}b")] = i
    return codes


def translate_svop(vop: bytes, time_bits: int, points: int) -> bytes:
    """An S-VOP (from its start code) with its warping points after the
    first set to 0: the warp becomes a translation (FFmpeg's gmc1 path).
    Progressive, rectangular VOLs only; a not-coded VOP is returned as is."""
    codes = _traj_codes()
    body = vop[4:].rstrip(b"\0")
    # without its next_start_code() stuffing ('0' then '1's to the byte)
    bits = "".join(format(b, "08b") for b in body).rstrip("1")[:-1]
    p = 2  # vop_coding_type
    while bits[p] == "1":  # modulo_time_base
        p += 1
    p += 1 + 1 + time_bits + 1  # its 0, marker, vop_time_increment, marker
    if bits[p] != "1":  # vop_coded
        return vop
    p += 1 + 1 + 3  # vop_coded, vop_rounding_type, intra_dc_vlc_thr
    out = bits[:p]
    for i in range(points):
        for _ in range(2):
            q = p
            while bits[p:q] not in codes:
                q += 1
            end = q + codes[bits[p:q]]  # the dmv_code's bits, then a marker
            out += bits[p:end + 1] if i == 0 else "00" + "1"
            p = end + 1
    out += bits[p:]
    out += "0" + "1" * (-(len(out) + 1) % 8)
    return vop[:4] + int(out, 2).to_bytes(len(out) // 8, "big")


def _gmc_translation_fixture(path: str) -> None:
    """libxvid's GMC stream (3 warping points, I/P/S, no B-frames) with
    every S-VOP's points 1 and 2 zeroed in place (the VOP padded with zero
    bytes to its length): translations, which libxvid does not choose on
    its own."""
    tmp = path + ".src.avi"
    write_lib(tmp, "avi", "libxvid", "XVID", 25, scene(12, 176, 144, 3),
              {"bf": "0", "g": "12", "b": "300k", "gmc": "1"})
    try:
        data = bytearray(open(tmp, "rb").read())
        vol = data.find(b"\x00\x00\x01\x20")
        bits = max(1, (_vol_resolution(bytes(data[vol:vol + 64])) - 1).bit_length())
        at = 0
        while True:
            at = data.find(b"\x00\x00\x01\xb6", at)
            if at < 0:
                break
            if data[at + 4] >> 6 == 3:  # an S-VOP: to the next start code or its chunk's end
                head = data.rfind(b"00dc", 0, at)
                end = head + 8 + struct.unpack_from("<I", data, head + 4)[0]
                nxt = data.find(b"\x00\x00\x01", at + 4)
                end = nxt if 0 <= nxt < end else end
                new = translate_svop(bytes(data[at:end]), bits, 3)
                assert len(new) <= end - at
                data[at:end] = new + b"\0" * (end - at - len(new))
            at += 4
        with open(path, "wb") as f:
            f.write(bytes(data))
    finally:
        os.remove(tmp)


def _nvop_fixture(path: str) -> None:
    tmp = path + ".src.avi"
    write_cv2(tmp, "XVID", 25, scene(12, 96, 64, 10))
    try:
        insert_nvops(tmp, path, (2, 5, 6))
    finally:
        os.remove(tmp)


def planes_sha(planes) -> list[str]:
    return [hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest() for p in planes]


def port_stats(path: str) -> dict:
    """The port's decoder's counts over the whole file (a read loop)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from fastvision_tpu_torch.data.avi import open_video
    video = open_video(path)
    for i in range(video.walk_count()):
        video.planes(i)
    stats = video.stats
    video.release()
    return stats


def main() -> None:
    import cv2
    os.makedirs(OUT, exist_ok=True)
    manifest = {"ffmpeg": {"libavcodec": "59.37.100", "cv2": cv2.__version__}, "fixtures": []}
    for fx in fixtures():
        path = os.path.join(OUT, fx["name"])
        fx["make"](path)
        planes = decode_lib(path)
        ys = [p[0] for p in planes]
        if fx.get("cv2_frames", True):
            oracle = cv2_oracle(path, ys)
            # cv2 (its own FFmpeg) must decode the same Y planes in its read loop
            if oracle["walk"] != list(range(len(planes))):
                raise RuntimeError(f"{fx['name']}: cv2's read loop is not libavcodec 59's frames")
            bound = rgb_bound(path)
        else:
            import cv2
            cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
            oracle = dict(frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                          fps=float(cap.get(cv2.CAP_PROP_FPS)), walk=None, landings=None,
                          landings_ascending=None)
            bound = None
        stats = port_stats(path)
        for feature in fx["features"]:
            if feature in FEATURE_STATS and not stats[FEATURE_STATS[feature]]:
                raise RuntimeError(f"{fx['name']}: the stream has no {feature}")
        h, w = ys[0].shape
        manifest["fixtures"].append(dict(
            file=fx["name"], bytes=os.path.getsize(path), width=w, height=h,
            features=fx["features"], frames=len(planes),
            sha256=[planes_sha(p) for p in planes], rgb_vs_videocapture=bound,
            stats=stats, **oracle))
        print(f"{fx['name']}: {os.path.getsize(path)} bytes, {len(planes)} frames, "
              f"cv2 count {oracle['frame_count']}, {stats}")
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    total = sum(e["bytes"] for e in manifest["fixtures"])
    print(f"total {total} bytes")


if __name__ == "__main__":
    main()
