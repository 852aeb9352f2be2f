"""An ISO base media file (``.mp4``, ISO/IEC 14496-12 / -14) muxer for one
MPEG-4 Part 2 video track, and `VideoWriter`, the port's counterpart of
cv2's ``VideoWriter(path, fourcc "mp4v", fps, (w, h))`` (`data.mpeg4`
encodes the frames).

The file is ``ftyp`` (isom, iso2, mp41), then ``mdat`` with every sample
in one chunk as frames arrive, then ``moov`` written by `Mp4Muxer.close`:

    moov  mvhd (timescale 1000)
          trak  tkhd (track 1, the frame size)
                mdia  mdhd (timescale = the rate's numerator), hdlr 'vide'
                      minf  vmhd, dinf/dref 'url ' (self-contained)
                            stbl  stsd: 'mp4v' sample entry with an 'esds'
                                        (ES descriptor, object type 0x20
                                        MPEG-4 Visual, stream type video,
                                        the VOS / VO / VOL headers as the
                                        decoder-specific info)
                                  stts (one entry: every sample the rate's
                                        denominator long), stss (every
                                        sample a sync sample), stsc (one
                                        chunk), stsz (each sample's size),
                                  stco (the chunk's offset)

With the media timescale and sample delta the rate's numerator and
denominator (`mpeg4.frame_rate`), a reader's average frame rate, timescale
over delta, is the asked fps: 25, 8, 5 and 30000/1001 read back exactly.
``mdat`` is preceded by an 8-byte ``free`` box, which `close` turns into
the 64-bit size field of a ``mdat`` over 4 GiB.

    with VideoWriter("out.mp4", 25, (640, 480)) as w:
        for rgb in frames:
            w.write(rgb)
"""
from __future__ import annotations

import collections
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .mpeg4 import Mpeg4Encoder, check_frame, mpeg4_library

ENCODE_THREADS = 4  # frames encoded at once (the library releases the interpreter's lock)


def box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _descriptor(tag: int, body: bytes) -> bytes:
    """An MPEG-4 systems descriptor with a 4-byte size field (0x80 0x80
    0x80 len, as FFmpeg writes it)."""
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F,
                  n & 0x7F])
    return bytes([tag]) + size + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Mp4Muxer:
    """One video track of MPEG-4 Part 2 samples into ``path``.
    ``timescale`` / ``sample_delta``: the frame rate; ``config``: the VOS /
    VO / VOL headers."""

    def __init__(self, path: str, width: int, height: int, timescale: int, sample_delta: int,
                 config: bytes):
        self.path, self.width, self.height = path, int(width), int(height)
        self.timescale, self.delta, self.config = int(timescale), int(sample_delta), config
        self.sizes: list[int] = []
        self._f = open(path, "wb")
        self._f.write(box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isom", b"iso2", b"mp41"))
        self._mdat_at = self._f.tell()
        self._f.write(box(b"free") + struct.pack(">I", 8) + b"mdat")  # size patched by close
        self._data_at = self._f.tell()

    def write(self, sample: bytes) -> None:
        self._f.write(sample)
        self.sizes.append(len(sample))

    def _moov(self) -> bytes:
        n, w, h = len(self.sizes), self.width, self.height
        media_duration = n * self.delta
        duration = round(media_duration * 1000 / self.timescale)
        esds = full_box(b"esds", 0, 0, _descriptor(0x03, struct.pack(">HB", 1, 0) + _descriptor(
            0x04, bytes([0x20, 0x11]) + struct.pack(">I", 0)[1:]
            + struct.pack(">II", *(min(2 ** 32 - 1, r) for r in (
                max(self.sizes, default=0) * 8 * self.timescale // self.delta,  # max, avg bit/s
                sum(self.sizes) * 8 * self.timescale // max(1, media_duration))))
            + _descriptor(0x05, self.config)) + _descriptor(0x06, b"\x02")))
        entry = box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1), bytes(32),
                    struct.pack(">Hh", 0x18, -1), esds)
        stbl = box(
            b"stbl",
            full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            full_box(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta) if n else
                     struct.pack(">I", 0)),
            full_box(b"stss", 0, 0, struct.pack(f">I{n}I", n, *range(1, n + 1))),
            full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1) if n else
                     struct.pack(">I", 0)),
            full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes)),
            full_box(b"stco", 0, 0, struct.pack(">II", 1, self._data_at) if n else
                     struct.pack(">I", 0)))
        minf = box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)),
                   box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                         full_box(b"url ", 0, 1))), stbl)
        mdia = box(b"mdia",
                   full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, self.timescale,
                                                       media_duration, 0x55C4, 0)),  # 'und'
                   full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0"),
                   minf)
        tkhd = full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, duration), bytes(8),
                        struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                        struct.pack(">II", w << 16, h << 16))
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, 1000, duration, 0x10000,
                                                   0x100), bytes(10), _MATRIX, bytes(24),
                        struct.pack(">I", 2))
        return box(b"moov", mvhd, box(b"trak", tkhd, mdia))

    def close(self) -> None:
        """Write ``moov`` and the ``mdat`` size; the file is complete."""
        if self._f.closed:
            return
        try:
            end = self._f.tell()
            size = end - self._data_at + 8
            self._f.seek(self._mdat_at)
            if size < 2 ** 32:
                self._f.write(box(b"free") + struct.pack(">I", size) + b"mdat")
            else:  # the free box's 8 bytes become the 64-bit size
                self._f.write(struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", size + 8))
            self._f.seek(end)
            self._f.write(self._moov())
        finally:
            self._f.close()


class VideoWriter:
    """uint8 RGB frames of ``size = (width, height)`` at ``fps`` -> an
    ``mp4v`` ``.mp4`` at ``path``: `mpeg4.Mpeg4Encoder` (intra-only, fixed
    quantiser) and `Mp4Muxer`. `write` stamps the frame and hands it to
    `ENCODE_THREADS` encoder threads (at most twice as many frames pending);
    the samples reach the file in order. ``close`` (or leaving the ``with``
    block) writes what is pending and completes the file; an encoder error
    is raised by the `write` or ``close`` that collects it."""

    def __init__(self, path: str, fps: float, size: tuple[int, int]):
        w, h = size
        self.encoder = Mpeg4Encoder(w, h, fps)
        mpeg4_library()  # built (or its build error raised) on the caller's thread
        rate = self.encoder.rate
        self.muxer = Mp4Muxer(path, w, h, rate.numerator, rate.denominator, self.encoder.config)
        self._pool = ThreadPoolExecutor(ENCODE_THREADS)
        self._pending: collections.deque = collections.deque()

    def write(self, rgb: np.ndarray) -> None:
        enc = self.encoder
        # a copy: the caller may reuse its buffer before the frame is encoded
        frame = np.array(check_frame(rgb, enc.width, enc.height))
        self._pending.append(self._pool.submit(enc.encode, frame, enc.stamp()))
        while self._pending and (len(self._pending) > 2 * ENCODE_THREADS
                                 or self._pending[0].done()):
            self.muxer.write(self._pending.popleft().result())

    def close(self) -> None:
        try:
            while self._pending:
                self.muxer.write(self._pending.popleft().result())
        finally:
            self._pool.shutdown()
            self.muxer.close()

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
