"""Video files without cv2: the port's counterpart of ``cv2.VideoCapture``,
as `codec` is its counterpart of ``cv2.imdecode``. AVI files are read
here: Motion-JPEG (`MJPEGAvi`) and MPEG-4 Part 2 (XviD, DivX, FMP4 and the
other FourCCs FFmpeg gives its ``mpeg4`` decoder, `mpeg4.MPEG4_FOURCCS`,
read by `mpeg4.Mpeg4Video`); ``.mp4`` / ``.mov`` / ``.m4v`` files go to
`mp4.open_mp4`. The port's readers decode those files on every machine;
a stream that does not decode raises ValueError, which never goes to cv2.
What they do not port goes to cv2's ``VideoCapture`` where cv2 imports, as
the JAX package reads every video: other codecs in those containers
(H.264, MS-MPEG4 ``DIV3`` / ``MP43``, ...), other containers (``.mkv``,
``.webm``), and the files the port's readers refuse with
``NotImplementedError`` (a fragmented MP4, an edit list that cuts frames,
the MPEG-4 tools and encoder builds `mpeg4` does not port, seeks in an AVI
whose first chunk is empty): at open where the headers show it, else from
the read that meets it on (`mpeg4.Mpeg4Video`; the port's frames and their
numbering are cv2's, so the clip stays whole). Each reader's ``reader``
says which decodes it ("port" or "cv2"). Where cv2 is absent those raise
``NotImplementedError`` naming item 11 and the codec, and never return a
black clip.

`open_video(path)` gives a reader with the calls the loaders make of a
``VideoCapture``: ``frame_count`` (``CAP_PROP_FRAME_COUNT``), ``fps``,
``read_at(i)`` (``set(CAP_PROP_POS_FRAMES, i)`` then ``read()``: RGB uint8
HWC, or None past the end), ``walk_count()`` (the frames a read loop from
the start gets) and ``frames()`` (that loop).

The container (RIFF ``AVI ``): ``LIST hdrl`` gives the first ``vids``
stream, its ``strh`` (FourCC, ``dwRate / dwScale``, ``dwLength``) and
``strf`` (compression, and an MPEG-4 stream's headers after the 40-byte
BITMAPINFOHEADER, where the writer put them there); ``LIST movi`` holds its
``##dc`` / ``##db`` chunks among ``JUNK``, ``LIST rec `` and OpenDML
``ix##`` chunks; ``idx1``, where it is present and agrees with the chunks
it names, lists them, else ``movi`` is walked once. OpenDML files (over 1
GB) continue in ``RIFF AVIX`` parts, whose ``movi`` lists are walked after
the first part's frames. A Motion-JPEG frame's bytes go through
`codec.decode_image` (a frame without Huffman tables gets the standard
ones; one cut short, or without its EOI, raises as cv2.imdecode gives no
image for it); an MPEG-4 stream's chunks are its samples in decode order.

What cv2 5.0.0 (its FFmpeg backend) does, and so what the readers do:

- the frame count is the stream header's ``dwLength`` (``avih``'s
  ``dwTotalFrames`` is not read), whatever ``movi`` and ``idx1`` hold;
- a zero-length frame chunk (a dropped frame) is no frame: reads skip it
  and the frames after it are numbered without it; in MPEG-4 so are
  N-VOPs and the placeholder chunks of packed B-frames, and frames are
  numbered in display order (`mpeg4.Mpeg4Video` states its rules);
- a seek is clamped to the frame count, so an index past an under-counting
  header reads the frame at the count; one past the real frames reads
  nothing;
- with a count of 0 or 1 a seek does not move: reads go on from the
  frame after the last one read;
- in a file whose first frame chunk is empty, cv2's seeks land on other
  frames than asked (its frame numbers start at 1 there, shown for
  Motion-JPEG): the readers refuse to seek in it (ValueError naming item
  11) and read it from the start only (ROADMAP Queue 3).

The Motion-JPEG pixels are libjpeg-turbo's (``cv2.imdecode`` of each
frame's bytes, bit for bit), not ``VideoCapture``'s: FFmpeg's MJPEG decoder
and swscale's chroma differ from libjpeg's fancy upsampling at colour
edges (ROADMAP Queue 3 gives the bound measured on the committed
fixtures). The MPEG-4 pixels are ``VideoCapture``'s own: FFmpeg's planes
and swscale's RGB (`mpeg4.planes_to_rgb`).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from .codec import decode_image
from .mpeg4 import MPEG4_FOURCCS, Mpeg4Video

_ITEM = "(ROADMAP Queue 1, item 11)"


class AviError(ValueError):
    """A file that is not an AVI this module reads (the caller tries cv2)."""


class OtherCodec(NotImplementedError):
    """A container the port reads holding a codec it does not decode
    (`open_video` hands the file to cv2 where it is installed)."""


def _chunks(data: bytes, start: int, end: int):
    """(fourcc, body start, body size) of the chunks in data[start:end],
    each padded to an even size; a chunk running past ``end`` is cut there."""
    pos = start
    while pos + 8 <= end:
        fcc = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = pos + 8
        yield fcc, body, min(size, end - body)
        pos = body + size + (size & 1)


class AviFile:
    """The first video stream of a RIFF AVI file: ``fourcc``,
    ``frame_count``, ``fps``, ``extradata`` (``strf`` past its
    BITMAPINFOHEADER) and its frame chunks [(offset, size)] in file order,
    empty ones included (see the module docstring). Raises `AviError` if
    the file is not a RIFF AVI."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self._data = data
        if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            raise AviError(f"not an AVI file: {path}")
        self.fourcc = b""
        self.extradata = b""
        self.stream = -1
        self.frame_count = 0
        self.fps = 0.0
        movi: list[tuple[int, int]] = []  # (offset of the 'movi' fourcc, end) of each part
        idx1 = None
        riff_end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
        parts = [(12, riff_end)]
        pos = riff_end + (riff_end & 1)
        while pos + 12 <= len(data) and data[pos:pos + 4] == b"RIFF":  # OpenDML AVIX parts
            size = struct.unpack_from("<I", data, pos + 4)[0]
            if data[pos + 8:pos + 12] == b"AVIX":
                parts.append((pos + 12, min(len(data), pos + 8 + size)))
            pos += 8 + size + (size & 1)
        for k, (start, end) in enumerate(parts):
            for fcc, body, size in _chunks(data, start, end):
                kind = data[body:body + 4]
                if fcc == b"LIST" and kind == b"hdrl" and k == 0:
                    self._read_hdrl(body + 4, body + size)
                elif fcc == b"LIST" and kind == b"movi":
                    movi.append((body, body + size))
                elif fcc == b"idx1" and k == 0:
                    idx1 = (body, size)
        if self.stream < 0:
            raise AviError(f"AVI without a video stream: {path}")
        if not movi:
            raise ValueError(f"corrupt AVI: no movi list: {path}")
        ids = (b"%02ddc" % self.stream, b"%02ddb" % self.stream)
        first = self._index(idx1, movi[0], ids) if idx1 else None
        if first is None:
            first = self._walk(*movi[0], ids)
        self.chunks = first + [c for m in movi[1:] for c in self._walk(*m, ids)]
        self._first_empty = bool(self.chunks) and self.chunks[0][1] == 0

    @property
    def codec(self) -> str:
        return self.fourcc.decode("latin-1")

    def refusal(self) -> str | None:
        """Why seeks are refused in this file (its first chunk is empty), or None."""
        if not self._first_empty:
            return None
        return (f"seeking in an AVI whose first frame chunk is empty is not ported {_ITEM}: "
                f"cv2 5.0.0 lands on other frames than asked there; {self.path}")

    def _read_hdrl(self, start: int, end: int) -> None:
        d = self._data
        n = 0  # stream number
        for fcc, body, size in _chunks(d, start, end):
            if fcc != b"LIST" or d[body:body + 4] != b"strl":
                continue
            strh = strf = None
            for f2, b2, s2 in _chunks(d, body + 4, body + size):
                if f2 == b"strh" and s2 >= 36:
                    strh = (b2, s2)
                elif f2 == b"strf":
                    strf = (b2, s2)
            if strh and d[strh[0]:strh[0] + 4] == b"vids" and self.stream < 0:
                b2 = strh[0]
                handler = d[b2 + 4:b2 + 8]
                scale, rate = struct.unpack_from("<II", d, b2 + 20)
                length = struct.unpack_from("<I", d, b2 + 32)[0]
                compression = d[strf[0] + 16:strf[0] + 20] if strf and strf[1] >= 20 else b""
                self.fourcc = compression if compression.strip(b"\0") else handler
                if strf and strf[1] > 40:
                    self.extradata = d[strf[0] + 40:strf[0] + strf[1]]
                self.stream = n
                self.frame_count = length
                self.fps = rate / scale if scale else 0.0
            n += 1

    def _walk(self, start: int, end: int, ids) -> list[tuple[int, int]]:
        """The stream's chunks in a ``movi`` list (its 'movi' fourcc at
        ``start``), descending into ``LIST rec ``."""
        out = []
        for fcc, body, size in _chunks(self._data, start + 4, end):
            if fcc == b"LIST":
                if self._data[body:body + 4] == b"rec ":
                    out += self._walk(body, body + size, ids)
            elif fcc in ids:
                out.append((body, size))
        return out

    def _index(self, idx1, movi, ids) -> list[tuple[int, int]] | None:
        """The stream's chunks from ``idx1`` (offsets from the 'movi'
        fourcc, or from the file's start), or None where an entry does not
        name a chunk of that size and id (the caller walks ``movi``)."""
        d, (body, size) = self._data, idx1
        entries = [struct.unpack_from("<4sIII", d, body + 16 * i) for i in range(size // 16)]
        entries = [e for e in entries if e[0] in ids]
        if not entries:
            return None
        for base in (movi[0], 0):
            out = []
            for fcc, _, offset, length in entries:
                at = base + offset
                if at + 8 + length > len(d) or d[at:at + 4] != fcc \
                        or struct.unpack_from("<I", d, at + 4)[0] != length:
                    break
                out.append((at + 8, length))
            else:
                return out
        return None



class MJPEGAvi(AviFile):
    """The first video stream of a Motion-JPEG AVI file (see the module
    docstring). Raises `AviError` if the file is not a RIFF AVI, and
    `OtherCodec` if its video is not MJPEG."""

    reader = "port"

    def __init__(self, path: str):
        super().__init__(path)
        if self.fourcc.upper() != b"MJPG":
            raise OtherCodec(f"{self.codec!r} video")
        self._frames = [(off, size) for off, size in self.chunks if size > 0]
        self._pos = 0  # the next frame a read gets

    def _refuse_seek(self) -> None:
        if self._first_empty:
            raise ValueError(self.refusal())

    def frame_bytes(self, i: int) -> bytes:
        off, size = self._frames[i]
        return self._data[off:off + size]

    def decode(self, i: int) -> np.ndarray:
        """Frame ``i`` of the real (non-empty) frames, RGB uint8 HWC; a frame
        that does not decode raises ValueError."""
        try:
            return decode_image(self.frame_bytes(i))
        except ValueError as e:
            raise ValueError(f"cannot decode frame {i} of {self.path}: {e}") from None

    def read_at(self, i: int) -> np.ndarray | None:
        """``cap.set(CAP_PROP_POS_FRAMES, i); cap.read()`` as cv2 5.0.0 does
        it: the seek clamped to the frame count, None past the real frames;
        with a count of 0 or 1 cv2 does not seek, and the read takes the
        frame after the last one read."""
        if self.frame_count > 1:
            self._refuse_seek()
            self._pos = min(max(int(i), 0), self.frame_count)
        if self._pos >= len(self._frames):
            return None
        self._pos += 1
        return self.decode(self._pos - 1)

    def walk_count(self) -> int:
        """``set(CAP_PROP_POS_FRAMES, 0)``, then the frames a read loop gets."""
        if self.frame_count > 1:
            self._refuse_seek()
            self._pos = 0
        n, self._pos = len(self._frames) - self._pos, len(self._frames)
        return max(n, 0)

    def frames(self):
        """Every frame in order, RGB uint8 HWC (a read loop from the start)."""
        for i in range(len(self._frames)):
            yield self.decode(i)

    def release(self) -> None:
        self._data = b""


def video_fourcc(path: str) -> str:
    """The FourCC (AVI) or sample entry (MP4 / MOV) of a video file's first
    video track, read from its bytes, or '?'."""
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        strh, strf = head.find(b"strh"), head.find(b"strf")
        if strf >= 0 and head[strf + 24:strf + 28].strip(b"\0"):
            return head[strf + 24:strf + 28].decode("latin-1")
        if strh >= 0:
            return head[strh + 12:strh + 16].decode("latin-1")
    at = head.find(b"stsd")
    if at >= 0 and at + 20 <= len(head):
        return head[at + 16:at + 20].decode("latin-1")
    return "?"


class _Cv2Video:
    """A video that cv2 reads: the same calls through ``cv2.VideoCapture``."""

    reader = "cv2"

    def __init__(self, path: str, cv2):
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self._next = 0  # the frame the next plain read() gets

    def frame(self, i: int) -> np.ndarray | None:
        """Frame ``i`` of a read loop: read on where the last read stopped,
        else ``set(CAP_PROP_POS_FRAMES, i)`` first (cv2 lands there as the
        port's readers number frames)."""
        if i != self._next:
            self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, int(i))
        self._next = i + 1
        return self._rgb(self._cap.read())

    def _rgb(self, ok_frame):
        ok, frame = ok_frame
        return self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB) if ok else None

    def read_at(self, i: int) -> np.ndarray | None:
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, int(i))
        self._next = -1
        return self._rgb(self._cap.read())

    def walk_count(self) -> int:
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
        n = 0
        while self._cap.read()[0]:
            n += 1
        self._next = -1
        return n

    def frames(self):
        self._next = -1
        while True:
            frame = self._rgb(self._cap.read())
            if frame is None:
                return
            yield frame

    def release(self) -> None:
        self._cap.release()


def open_avi(path: str):
    """The reader of an AVI's first video stream: `MJPEGAvi`, or
    `mpeg4.Mpeg4Video` for the MPEG-4 FourCCs; `OtherCodec` for the rest."""
    avi = AviFile(path)
    if avi.fourcc.upper() == b"MJPG":
        return MJPEGAvi(path)
    if avi.codec.upper() not in MPEG4_FOURCCS:
        raise OtherCodec(f"{avi.codec!r} video")
    samples = [c for c in avi.chunks if c[1] > 0]
    return Mpeg4Video(path, avi._data, samples, avi.extradata, avi.codec, avi.frame_count,
                      avi.fps, avi.refusal())


def import_cv2():
    """cv2, or None where it cannot be imported."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def open_video(path: str):
    """A reader for ``path``: the port's for AVI (Motion-JPEG and MPEG-4
    Part 2) and for ``.mp4`` / ``.mov`` / ``.m4v`` (MPEG-4 Part 2,
    `mp4.open_mp4`), with or without cv2; cv2's ``VideoCapture`` behind the
    same calls for other codecs and containers, and for the files the
    port's readers refuse at open (NotImplementedError) or would refuse to
    seek in. Where cv2 is absent, those raise NotImplementedError naming
    item 11 and the codec (seeks in an AVI whose first chunk is empty
    raise ValueError when made); a missing file raises FileNotFoundError."""
    from .mp4 import is_mp4, open_mp4

    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    cv2, refused = import_cv2(), None
    try:
        video = open_avi(path)
        if video.refusal() is None or cv2 is None:
            return video
        video.release()
        return _Cv2Video(path, cv2)
    except (AviError, OtherCodec):
        pass
    except NotImplementedError as e:
        refused = e
    if refused is None and is_mp4(path):
        try:
            return open_mp4(path)
        except OtherCodec:
            pass
        except NotImplementedError as e:
            refused = e
    if cv2 is None:
        if refused is not None:
            raise refused
        raise NotImplementedError(
            f"decoding {video_fourcc(path)!r} video without cv2 is not ported {_ITEM}: "
            f"{path}; Motion-JPEG and MPEG-4 Part 2 (XviD, DivX, mp4v) in AVI, MP4 and MOV, "
            f"and clips stored as directories of frames, are read without it")
    return _Cv2Video(path, cv2)
