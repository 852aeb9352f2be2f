"""ISO base media files (``.mp4`` / ``.mov`` / ``.m4v``, ISO/IEC 14496-12 /
-14, QuickTime): `open_mp4`, the reader of their first MPEG-4 Part 2 video
track (`mpeg4.Mpeg4Video` decodes it), and a muxer for one such track with
`VideoWriter`, the port's counterpart of cv2's ``VideoWriter(path, fourcc
"mp4v", fps, (w, h))`` (`data.mpeg4` encodes the frames).

The reader: the top-level boxes (``ftyp``, ``moov``, ``mdat``, ...; a
``moof``, or ``mvex`` in ``moov``, is a fragmented file, which raises
NotImplementedError naming ROADMAP Queue 1 item 11); in ``moov`` the
first ``trak`` whose ``mdia/hdlr`` is ``vide``: ``mdhd`` (the timescale),
``stsd`` (its first sample entry: ``mp4v`` with an ``esds`` whose decoder
config names MPEG-4 Visual, 0x20, and holds the VOS / VO / VOL headers;
any other entry, ``avc1``, ``hvc1``, ``av01``, ..., is another codec:
`avi.OtherCodec`, read by cv2 where it is installed), ``stts`` (the
durations), ``ctts`` (the composition offsets), ``stss`` (the sync
samples), ``stsc`` / ``stsz`` (or ``stz2``) / ``stco`` (or ``co64``) (the
samples' places) and ``edts/elst``. As cv2 5.0.0 (FFmpeg's demuxer) counts
them: the frame count is the sample count, fps the samples over the summed
durations times the timescale; frames are shown in display order (an edit
list that starts at the first frame shown, as FFmpeg writes for B-frames,
changes nothing; one that cuts frames raises, naming item 11).

The muxer:

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

from .mpeg4 import Mpeg4Encoder, Mpeg4Video, check_frame, mpeg4_library

ENCODE_THREADS = 4  # frames encoded at once (the library releases the interpreter's lock)
_ITEM = "(ROADMAP Queue 1, item 11)"
_TOP_BOXES = {b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot", b"uuid", b"moof"}


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


# --- reading ----------------------------------------------------------------

def _boxes(d: bytes, start: int, end: int):
    """(type, body start, body end) of the boxes in d[start:end] (64-bit
    and to-the-end sizes; a box running past ``end`` is cut there)."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", d, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                return
            size, head = struct.unpack_from(">Q", d, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head:
            raise ValueError(f"corrupt MP4: a {kind!r} box of {size} bytes")
        yield kind, pos + head, min(pos + size, end)
        pos += size


def _child(d: bytes, start: int, end: int, kind: bytes):
    for k, b, e in _boxes(d, start, end):
        if k == kind:
            return b, e
    return None


def _read_descriptor(d: bytes, pos: int, end: int) -> tuple[int, int, int]:
    """An MPEG-4 systems descriptor at pos -> (tag, body start, body end)."""
    if pos >= end:
        raise ValueError("corrupt MP4: esds ends early")
    tag, n, pos = d[pos], 0, pos + 1
    for _ in range(4):
        if pos >= end:
            raise ValueError("corrupt MP4: esds ends early")
        b = d[pos]
        pos += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, min(pos + n, end)


def _esds_config(d: bytes, start: int, end: int) -> tuple[int, bytes]:
    """An ``esds`` body -> (objectTypeIndication, decoder-specific info)."""
    tag, b, e = _read_descriptor(d, start + 4, end)  # past version / flags
    if tag != 0x03:
        raise ValueError("corrupt MP4: esds without an ES descriptor")
    flags = d[b + 2]
    b += 3 + (2 if flags & 0x80 else 0) + (2 if flags & 0x20 else 0)
    if flags & 0x40:
        b += 1 + d[b]
    while b < e:
        tag, db, de = _read_descriptor(d, b, e)
        if tag == 0x04:
            oti = d[db]
            sub = db + 13
            while sub < de:
                t2, b2, e2 = _read_descriptor(d, sub, de)
                if t2 == 0x05:
                    return oti, d[b2:e2]
                sub = e2
            return oti, b""
        b = de
    raise ValueError("corrupt MP4: esds without a decoder config")


def is_mp4(path: str) -> bool:
    """Whether ``path`` starts with an ISO base media / QuickTime box."""
    with open(path, "rb") as f:
        head = f.read(8)
    return len(head) == 8 and head[4:8] in _TOP_BOXES


class Mp4File:
    """The first video track of an ISO base media file (see the module
    docstring): ``codec`` (its sample entry), ``config``, ``samples``
    [(offset, size)] in decode order, ``frame_count``, ``fps``, ``sync``
    (the sync samples, 0-based; None: all), ``pts`` (each sample's
    composition time) and ``edits`` [(media_time, duration)]."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._data = d = f.read()
        top = {k: (b, e) for k, b, e in reversed(list(_boxes(d, 0, len(d))))}
        if b"moov" not in top:
            raise ValueError(f"corrupt MP4: no moov box: {path}")
        self.fragmented = b"moof" in top or _child(d, *top[b"moov"], b"mvex") is not None
        trak = None
        for k, b, e in _boxes(d, *top[b"moov"]):
            mdia = _child(d, b, e, b"mdia") if k == b"trak" else None
            hdlr = mdia and _child(d, *mdia, b"hdlr")
            if hdlr and d[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
                trak = (b, e, mdia)
                break
        if trak is None:
            raise ValueError(f"MP4 without a video track: {path}")
        tb, te, mdia = trak
        mdhd = _child(d, *mdia, b"mdhd")
        version = d[mdhd[0]]
        self.timescale = struct.unpack_from(">I", d, mdhd[0] + (20 if version == 1 else 12))[0]
        stbl = self._stbl(mdia)
        sb, se = _child(d, *stbl, b"stsd")
        entry = next(_boxes(d, sb + 8, se), None)
        if entry is None:
            raise ValueError(f"corrupt MP4: empty stsd: {path}")
        kind, eb, ee = entry
        self.codec = kind.decode("latin-1")
        self.config, self.object_type = b"", None
        if kind == b"mp4v":
            esds = _child(d, eb + 78, ee, b"esds")
            if esds is None:
                raise ValueError(f"corrupt MP4: mp4v without esds: {path}")
            self.object_type, self.config = _esds_config(d, *esds)
        self._samples(stbl)
        edts = _child(d, tb, te, b"edts")
        elst = edts and _child(d, *edts, b"elst")
        self.edits = []
        if elst:
            v, (n,) = d[elst[0]], struct.unpack_from(">I", d, elst[0] + 4)
            fmt, step = (">QqHH", 20) if v == 1 else (">IiHH", 12)
            for i in range(n):
                dur, media_time, rate, _ = struct.unpack_from(fmt, d, elst[0] + 8 + i * step)
                self.edits.append((media_time, dur, rate))

    def _stbl(self, mdia):
        d = self._data
        minf = _child(d, *mdia, b"minf")
        stbl = minf and _child(d, *minf, b"stbl")
        if not stbl:
            raise ValueError(f"corrupt MP4: no stbl: {self.path}")
        return stbl

    def _table(self, stbl, kind: bytes, fmt: str):
        box = _child(self._data, *stbl, kind)
        if box is None:
            return None
        b, e = box
        n = struct.unpack_from(">I", self._data, b + 4)[0]
        size = struct.calcsize(fmt)
        if b + 8 + n * size > e:
            raise ValueError(f"corrupt MP4: {kind.decode()} runs past its box: {self.path}")
        return [struct.unpack_from(fmt, self._data, b + 8 + i * size) for i in range(n)]

    def _samples(self, stbl) -> None:
        d = self._data
        stsz = _child(d, *stbl, b"stsz")
        if stsz:
            fixed, n = struct.unpack_from(">II", d, stsz[0] + 4)
            sizes = [fixed] * n if fixed else list(struct.unpack_from(f">{n}I", d, stsz[0] + 12))
        else:
            stz2 = _child(d, *stbl, b"stz2")
            if stz2 is None:
                raise ValueError(f"corrupt MP4: no stsz: {self.path}")
            field, n = d[stz2[0] + 7], struct.unpack_from(">I", d, stz2[0] + 8)[0]
            raw = d[stz2[0] + 12:]
            if field == 16:
                sizes = list(struct.unpack_from(f">{n}H", raw))
            elif field == 8:
                sizes = list(raw[:n])
            else:
                sizes = [(raw[i // 2] >> (4 * (1 - i % 2))) & 15 for i in range(n)]
        chunks = self._table(stbl, b"stco", ">I") or self._table(stbl, b"co64", ">Q") or []
        stsc = self._table(stbl, b"stsc", ">III") or []
        samples, k = [], 0
        for j, (first, per_chunk, _) in enumerate(stsc):
            last = stsc[j + 1][0] - 1 if j + 1 < len(stsc) else len(chunks)
            for c in range(first - 1, last):
                if c >= len(chunks):
                    raise ValueError(f"corrupt MP4: stsc names chunk {c + 1}: {self.path}")
                off = chunks[c][0]
                for _ in range(per_chunk):
                    if k >= n:
                        break
                    samples.append((off, sizes[k]))
                    off += sizes[k]
                    k += 1
        if k != n or any(o + s > len(d) for o, s in samples):
            raise ValueError(f"corrupt MP4: the sample tables do not place {n} samples: "
                             f"{self.path}")
        self.samples = samples
        self.frame_count = n
        deltas = [delta for count, delta in self._table(stbl, b"stts", ">II") or []
                  for _ in range(count)]
        self.fps = n * self.timescale / sum(deltas) if deltas and sum(deltas) else 0.0
        offsets = [off for count, off in self._table(stbl, b"ctts", ">Ii") or []
                   for _ in range(count)]
        dts = [0]
        for delta in deltas[:-1]:
            dts.append(dts[-1] + delta)
        self.pts = [t + (offsets[i] if i < len(offsets) else 0) for i, t in enumerate(dts)]
        stss = self._table(stbl, b"stss", ">I")
        self.sync = None if stss is None else [s - 1 for (s,) in stss]


def open_mp4(path: str) -> Mpeg4Video:
    """The reader of an ``.mp4`` / ``.mov`` / ``.m4v`` file's first video
    track, MPEG-4 Part 2 (see the module docstring); `avi.OtherCodec` for
    another codec, NotImplementedError naming item 11 for a fragmented file
    or an edit list that cuts frames."""
    from .avi import OtherCodec

    f = Mp4File(path)
    if f.codec != "mp4v" or f.object_type != 0x20:
        what = f.codec if f.codec != "mp4v" else f"mp4v object type 0x{f.object_type:02x}"
        raise OtherCodec(f"{what!r} video")
    if f.fragmented:
        raise NotImplementedError(f"reading fragmented MP4 files is not ported {_ITEM}: {path}")
    edits = [(t, dur, rate) for t, dur, rate in f.edits if t != -1]
    if len(edits) > 1 or any(rate != 1 for _, _, rate in edits) or (
            edits and f.pts and edits[0][0] > min(f.pts)):
        raise NotImplementedError(f"MP4 edit lists that cut or repeat frames are not ported "
                                  f"{_ITEM}: {path}")
    return Mpeg4Video(path, f._data, f.samples, f.config, "mp4v", f.frame_count, f.fps)
