"""MPEG-4 Part 2 (ISO/IEC 14496-2) video: `Mpeg4Decoder` and `Mpeg4Video`,
the port's reader of XviD / DivX / mp4v streams (the AVI, MP4 and MOV
readers, `data.avi` and `data.mp4`, hand it their samples), and
`Mpeg4Encoder`, a Simple Profile intra-only encoder, the port's writer of
annotated videos (`data.mp4.VideoWriter` muxes its frames into an ``mp4v``
``.mp4``, the file cv2's ``mp4v`` ``VideoWriter`` writes in the JAX
package).

The decoder is ``csrc/mpeg4_decode.cpp`` (built by `cuda_build` with the
host compiler, called through ctypes with the interpreter's lock
released): FFmpeg's ``mpeg4`` decoder's output bit for bit, the decoder
cv2's ``VideoCapture`` uses (its source says how, and what raises). Its
planes become RGB as swscale converts them for cv2 (`planes_to_rgb`).
`Mpeg4Video` gives `avi.open_video`'s calls over a stream's samples, with
the frame order, frame count and seeks of cv2 (its docstring).

The encoder:

Each frame is encoded by ``csrc/mpeg4_encode.cpp`` (built by `cuda_build`
with the host compiler, called through ctypes, the interpreter's lock
released): RGB -> Y'CbCr 4:2:0 in BT.601 limited range (as swscale
converts for cv2's writer; each chroma sample the mean of its 2 x 2
pixels; the frame padded to whole macroblocks by repeating its last row
and column, the true size in the VOL header), an 8 x 8 DCT-II of each
block, H.263 quantisation at one fixed quantiser (`QUANT` = 2: the intra DC
by Table 7-1's scaler, 8 here; each AC level ``floor(|F| / 2q)``, at least
1 from ``1.5 q``), DC prediction from the left or upper block, no AC
prediction, and the bitstream: every level, the DC difference first, as a
fixed-length escape (``intra_dc_vlc_thr`` 7), about 30 bits a non-zero
level. Every frame is an I-VOP, so every frame is a sync sample and the
file keeps ``quant``'s quality throughout. This module writes the VOS, VO
and VOL headers (`Mpeg4Encoder.config`, the container's ``esds``), each
VOP's time stamp, and what a decoder reconstructs (`Mpeg4Encoder.
reconstruct`, for checks).

    enc = Mpeg4Encoder(640, 480, fps=25)
    vop = enc.encode(rgb)          # bytes of one I-VOP
    rec = enc.reconstruct(enc.levels(rgb))   # what a decoder shows

    dec = Mpeg4Decoder(config)     # the VOL from the container, or b""
    for frame in dec.decode(vop) + dec.flush():   # YUVFrame(y, cb, cr, tag)
        rgb = planes_to_rgb(frame.y, frame.cb, frame.cr)
"""
from __future__ import annotations

import ctypes
import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np

from .. import cuda_build

QUANT = 2  # the fixed quantiser (vop_quant) of every frame
_K = np.arange(8)
# the orthonormal 8-point DCT-II: F = D @ block @ D.T, block = D.T @ F @ D
DCT = np.sqrt(np.where(_K[:, None] == 0, 1.0, 2.0) / 8) * np.cos(
    (2 * _K[None, :] + 1) * _K[:, None] * np.pi / 16)
_ERR_LEN = 256


def dc_scalers(quant: int) -> tuple[int, int]:
    """The intra DC scaler of luminance and chrominance blocks at
    ``quant`` (ISO/IEC 14496-2 Table 7-1)."""
    if quant <= 4:
        return 8, 8
    luma = 2 * quant if quant <= 8 else quant + 8 if quant <= 24 else 2 * quant - 16
    chroma = (quant + 13) // 2 if quant <= 24 else quant - 6
    return luma, chroma


def frame_rate(fps: float) -> Fraction:
    """``fps`` as the fraction the stream stores: the nearest with a
    denominator up to 1001 (30000/1001 for NTSC's 29.97...) whose numerator,
    the VOL's ``vop_time_increment_resolution``, fits its 16 bits."""
    if not fps > 0:
        raise ValueError(f"fps must be > 0, got {fps}")
    for limit in (1001, 100, 10, 1):
        rate = Fraction(fps).limit_denominator(limit)
        if 0 < rate.numerator < 65536:
            return rate
    raise ValueError(f"fps {fps} does not fit a 16-bit time resolution")


def mpeg4_library() -> ctypes.CDLL:
    """``csrc/mpeg4_encode.cpp``, built on first use."""
    lib = cuda_build.load("mpeg4_encode")
    if not getattr(lib, "_fv_typed", False):
        lib.fvm_yuv420.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.fvm_yuv420.restype = ctypes.c_int
        lib.fvm_encode_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_int]
        lib.fvm_encode_frame.restype = ctypes.c_long
        lib._fv_typed = True
    return lib


def check_frame(rgb: np.ndarray, width: int, height: int) -> np.ndarray:
    """``rgb`` as a C-contiguous uint8 [height, width, 3], or ValueError."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.shape != (height, width, 3) or rgb.dtype != np.uint8:
        raise ValueError(f"a frame must be uint8 [{height}, {width}, 3], got "
                         f"{rgb.dtype} {list(rgb.shape)}")
    return rgb


def rgb_to_yuv420(rgb: np.ndarray) -> tuple[np.ndarray, ...]:
    """uint8 RGB [H, W, 3] -> the encoder's uint8 planes: Y [16 mb_h, 16
    mb_w], Cb and Cr [8 mb_h, 8 mb_w] (BT.601 limited range, the edges
    repeated to whole macroblocks)."""
    h, w = rgb.shape[:2]
    rgb = check_frame(rgb, w, h)
    mb_h, mb_w = math.ceil(h / 16), math.ceil(w / 16)
    y = np.empty((16 * mb_h, 16 * mb_w), np.uint8)
    cb, cr = (np.empty((8 * mb_h, 8 * mb_w), np.uint8) for _ in range(2))
    mpeg4_library().fvm_yuv420(rgb.ctypes.data, w, h, y.ctypes.data, cb.ctypes.data,
                               cr.ctypes.data)
    return y, cb, cr


def yuv420_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, h: int, w: int) -> np.ndarray:
    """The inverse of `rgb_to_yuv420` (chroma repeated over its 2 x 2
    pixels), cropped to [h, w, 3] uint8."""
    y = (y.astype(np.float32) - 16) * (255 / 219)
    cb = (np.repeat(np.repeat(cb, 2, 0), 2, 1).astype(np.float32) - 128) * (255 / 224)
    cr = (np.repeat(np.repeat(cr, 2, 0), 2, 1).astype(np.float32) - 128) * (255 / 224)
    rgb = np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], -1)
    return np.clip(np.rint(rgb[:h, :w]), 0, 255).astype(np.uint8)


def _planes(blocks: np.ndarray, mb_h: int, mb_w: int) -> tuple[np.ndarray, ...]:
    """[n_mb, 6, 8, 8] blocks (Y0 Y1 Y2 Y3 Cb Cr, macroblocks in raster
    order) -> the Y, Cb and Cr planes."""
    luma = blocks[:, :4].reshape(mb_h, mb_w, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5)
    chroma = [blocks[:, i].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3)
              .reshape(8 * mb_h, 8 * mb_w) for i in (4, 5)]
    return (luma.reshape(16 * mb_h, 16 * mb_w), *chroma)


def dequantize(levels: np.ndarray, quant: int) -> np.ndarray:
    """Levels [n_mb, 6, 8, 8] -> the DCT coefficients a decoder
    reconstructs (7.4.4.1)."""
    ys, cs = dc_scalers(quant)
    mag = quant * (2 * np.abs(levels) + 1) - (1 - quant % 2)
    coefs = np.where(levels == 0, 0, np.sign(levels) * mag).astype(np.float64)
    coefs[:, :, 0, 0] = levels[:, :, 0, 0] * np.array([ys] * 4 + [cs] * 2)[None, :]
    return np.clip(coefs, -2048, 2047)


class _Bits:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def stuffing(self) -> None:  # next_start_code()
        self.put(0, 1)
        while len(self.bits) % 8:
            self.put(1, 1)

    def bytes(self) -> bytes:
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


class Mpeg4Encoder:
    """One ``width x height`` stream at ``fps``: `config` (the VOS, VO and
    VOL headers), then `encode` per frame (an I-VOP, its time stamp the
    frame's index over `rate`)."""

    def __init__(self, width: int, height: int, fps: float):
        if not (0 < width < 8192 and 0 < height < 8192):
            raise ValueError(f"frame size {width} x {height} outside the VOL's 13-bit fields")
        self.width, self.height, self.quant = int(width), int(height), QUANT
        self.mb_w, self.mb_h = math.ceil(width / 16), math.ceil(height / 16)
        self.rate = frame_rate(fps)
        # vop_time_increment: as many bits as resolution - 1 needs, at least 1
        self.time_bits = max(1, (self.rate.numerator - 1).bit_length())
        self.frames = 0
        self._seconds = 0

    @property
    def config(self) -> bytes:
        """visual_object_sequence (Simple Profile level 1), visual_object
        and video_object_layer headers: rectangular, progressive, 4:2:0,
        low delay, H.263 quantisation, no resync markers, no data
        partitioning, the frame size and ``vop_time_increment_resolution``
        = the rate's numerator."""
        b = _Bits()
        b.put(0x000001B0, 32)
        b.put(0x01, 8)  # profile_and_level_indication: Simple Profile, level 1
        b.put(0x000001B5, 32)  # visual_object_start_code
        b.put(1, 1)  # is_visual_object_identifier
        b.put(1, 4)  # visual_object_verid
        b.put(1, 3)  # visual_object_priority
        b.put(1, 4)  # visual_object_type: video
        b.put(0, 1)  # video_signal_type
        b.stuffing()
        b.put(0x00000100, 32)  # video_object_start_code
        b.put(0x00000120, 32)  # video_object_layer_start_code
        b.put(1, 1)  # random_accessible_vol: every VOP is intra
        b.put(1, 8)  # video_object_type_indication: Simple Object
        b.put(1, 1)  # is_object_layer_identifier
        b.put(1, 4)  # video_object_layer_verid
        b.put(1, 3)  # video_object_layer_priority
        b.put(1, 4)  # aspect_ratio_info: square pixels
        b.put(1, 1)  # vol_control_parameters
        b.put(1, 2)  # chroma_format: 4:2:0
        b.put(1, 1)  # low_delay
        b.put(0, 1)  # vbv_parameters
        b.put(0, 2)  # video_object_layer_shape: rectangular
        b.put(1, 1)
        b.put(self.rate.numerator, 16)  # vop_time_increment_resolution
        b.put(1, 1)
        b.put(0, 1)  # fixed_vop_rate
        b.put(1, 1)
        b.put(self.width, 13)
        b.put(1, 1)
        b.put(self.height, 13)
        b.put(1, 1)
        b.put(0, 1)  # interlaced
        b.put(1, 1)  # obmc_disable
        b.put(0, 1)  # sprite_enable
        b.put(0, 1)  # not_8_bit
        b.put(0, 1)  # quant_type: H.263
        b.put(1, 1)  # complexity_estimation_disable
        b.put(1, 1)  # resync_marker_disable
        b.put(0, 1)  # data_partitioned
        b.put(0, 1)  # scalability
        b.stuffing()
        return b.bytes()

    def _encode(self, rgb: np.ndarray, seconds: int, increment: int,
                levels: np.ndarray | None) -> bytes:
        rgb = check_frame(rgb, self.width, self.height)
        n_mb = self.mb_w * self.mb_h
        # at most 30 bits a level and 16 a macroblock header, plus the VOP header
        out = np.empty(64 + seconds // 8 + n_mb * (6 * 64 * 30 + 16) // 8, np.uint8)
        err = ctypes.create_string_buffer(_ERR_LEN)
        n = mpeg4_library().fvm_encode_frame(
            rgb.ctypes.data, self.width, self.height, self.quant, seconds, increment,
            self.time_bits, None if levels is None else levels.ctypes.data, out.ctypes.data,
            out.size, err, _ERR_LEN)
        if n < 0:
            raise ValueError(f"MPEG-4 encoder: {err.value.decode()}")
        return out[:n].tobytes()

    def levels(self, rgb: np.ndarray) -> np.ndarray:
        """uint8 RGB [height, width, 3] -> the quantised levels [n_mb, 6, 8,
        8] (int16, raster order; the DC as a level, before its prediction)."""
        levels = np.empty((self.mb_w * self.mb_h, 6, 8, 8), np.int16)
        self._encode(rgb, 0, 0, levels)
        return levels

    def _macroblock_planes(self, levels: np.ndarray) -> tuple[np.ndarray, ...]:
        pix = np.clip(np.rint(DCT.T @ dequantize(levels, self.quant) @ DCT), 0, 255)
        return _planes(pix.astype(np.uint8), self.mb_h, self.mb_w)

    def reconstruct_planes(self, levels: np.ndarray) -> tuple[np.ndarray, ...]:
        """Levels -> the Y, Cb, Cr planes they decode to, cropped to the frame
        (a float IDCT; a decoder's integer IDCT may differ by one level)."""
        y, cb, cr = self._macroblock_planes(levels)
        ch, cw = (self.height + 1) // 2, (self.width + 1) // 2
        return y[:self.height, :self.width], cb[:ch, :cw], cr[:ch, :cw]

    def reconstruct(self, levels: np.ndarray) -> np.ndarray:
        """Levels -> the uint8 RGB frame they decode to (a float IDCT; a
        decoder's integer IDCT may differ by one level)."""
        return yuv420_to_rgb(*self._macroblock_planes(levels), self.height, self.width)

    def stamp(self) -> tuple[int, int]:
        """The next frame's time stamp: (seconds since the last frame's
        second, vop_time_increment); advances the stream by one frame."""
        t = self.frames * self.rate.denominator
        seconds = t // self.rate.numerator
        stamp = (seconds - self._seconds, t % self.rate.numerator)
        self.frames += 1
        self._seconds = seconds
        return stamp

    def encode(self, rgb: np.ndarray, stamp: tuple[int, int] | None = None) -> bytes:
        """One uint8 RGB frame -> the bytes of its I-VOP, time-stamped as
        the stream's next frame (or with ``stamp``, from `stamp`: frames
        stamped in order may be encoded on several threads at once)."""
        seconds, increment = self.stamp() if stamp is None else stamp
        return self._encode(rgb, seconds, increment, None)


# --- decoding -------------------------------------------------------------

_ITEM = "(ROADMAP Queue 1, item 11)"
# the AVI FourCCs FFmpeg's RIFF table gives its mpeg4 decoder (matched in
# upper case, as FFmpeg retries a tag)
MPEG4_FOURCCS = frozenset(
    "FMP4 DIVX DX50 XVID MP4S M4S2 DIV1 BLZ0 MP4V UMP4 WV1F SEDG RMP4 3IV2 WAWV FFDS FVFW "
    "DCOD MVXM PM4V SMP4 DXGM VIDM M4T3 GEOX HDX4 DM4V DMK2 DIGI INMC EPHV EM4A M4CC SN40 "
    "VSPX ULDX GEOV SIPP SM4V XVIX DREX QMP4 PLV1 GLV4 GMP4 MNM4 GTM4 ZMP4".split())
_N_STATS = 31
STATS = ("i_vops", "p_vops", "b_vops", "n_vops", "packed_b_vops", "skipped_b_vops",
         "intra_mbs_in_p", "inter4v_mbs", "skipped_p_mbs", "direct_mbs", "forward_mbs",
         "backward_mbs", "bidirectional_mbs", "skipped_b_mbs", "dquant_mbs", "video_packets",
         "quarter_pel", "mpeg_quant", "loaded_intra_matrix", "loaded_inter_matrix",
         "xvid_idct", "rounding_type_1_vops", "ac_pred_mbs", "escape3_levels", "interlaced",
         "field_mbs", "partitioned_vops", "alternate_scan_vops", "gmc_translation_vops",
         "gmc_mbs", "gmc_affine_vops")
assert len(STATS) == _N_STATS


class YUVFrame(NamedTuple):
    """A decoded frame: the Y [h, w], Cb and Cr [(h + 1) // 2, (w + 1) // 2]
    uint8 planes and the tag of the packet its VOP came from (plus 2**32
    for a packet's second, packed, VOP)."""
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    tag: int


def decoder_library() -> ctypes.CDLL:
    """``csrc/mpeg4_decode.cpp``, built on first use."""
    lib = cuda_build.load("mpeg4_decode")
    if not getattr(lib, "_fv_typed", False):
        vp, i, l, u8 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_char_p
        lib.fvd_open.argtypes = [u8, l, ctypes.c_uint32, u8, i]
        lib.fvd_open.restype = vp
        lib.fvd_decode.argtypes = [vp, u8, l, l, i, u8, i]
        lib.fvd_decode.restype = i
        lib.fvd_take.argtypes = [vp, vp, vp, vp, ctypes.POINTER(l)]
        lib.fvd_take.restype = i
        lib.fvd_info.argtypes = [vp, ctypes.POINTER(l)]
        lib.fvd_info.restype = i
        lib.fvd_rgb.argtypes = [vp, vp, vp, i, i, vp]
        lib.fvd_rgb.restype = None
        lib.fvd_reset.argtypes = [vp]
        lib.fvd_reset.restype = None
        lib.fvd_close.argtypes = [vp]
        lib.fvd_close.restype = None
        lib._fv_typed = True
    return lib


def _raise(code: int, err: bytes, where: str):
    msg = err.decode(errors="replace")
    if code == -2:
        raise NotImplementedError(f"decoding {msg} is not ported {_ITEM}: {where}")
    raise ValueError(f"corrupt MPEG-4 video ({msg}): {where}")


class Mpeg4Decoder:
    """One MPEG-4 Part 2 stream. ``config``: the VOS / VO / VOL headers the
    container holds (AVI ``strf`` extradata, MP4 ``esds``), or b"" where the
    VOL comes in the stream; ``fourcc``: the AVI FourCC (it names the
    encoder where the stream does not). `decode` takes one container sample
    and gives the frames ready (0 or 1, display order); `flush` ends the
    stream; `reset` drops the pictures for a seek. A stream that does not
    decode raises ValueError, an unsupported feature NotImplementedError
    naming item 11; a decoder that raised is not used again."""

    def __init__(self, config: bytes = b"", fourcc: str = "", name: str = "MPEG-4 stream"):
        self._lib = decoder_library()
        self.name = name
        err = ctypes.create_string_buffer(_ERR_LEN)
        tag = fourcc.encode("latin-1")[:4].ljust(4, b"\0") if fourcc else b"\0" * 4
        self._h = self._lib.fvd_open(config, len(config), int.from_bytes(tag, "little"), err,
                                     _ERR_LEN)
        if not self._h:
            msg = err.value
            _raise(-2 if msg.startswith(b"unsupported: ") else -1,
                   msg.removeprefix(b"unsupported: "), name)
        self._err = err
        self._info = (ctypes.c_long * (2 + _N_STATS))()

    def _call(self, data: bytes, tag: int, parse_only: bool) -> list:
        rc = self._lib.fvd_decode(self._h, data, len(data), tag, int(parse_only), self._err,
                                  _ERR_LEN)
        if rc < 0:
            _raise(rc, self._err.value, self.name)
        if not rc:
            return []
        if parse_only:
            t = ctypes.c_long()
            self._lib.fvd_take(self._h, None, None, None, ctypes.byref(t))
            return [t.value]
        w, h = self.size
        y = np.empty((h, w), np.uint8)
        cb, cr = (np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8) for _ in range(2))
        t = ctypes.c_long()
        self._lib.fvd_take(self._h, y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
                           ctypes.byref(t))
        return [YUVFrame(y, cb, cr, t.value)]

    def decode(self, vop: bytes, tag: int = 0, parse_only: bool = False) -> list:
        """One sample -> the frames it completes ([] or [YUVFrame]); an
        empty sample is skipped (a dropped frame). ``parse_only``: headers
        and frame order only, the frames' tags instead of frames."""
        return self._call(vop, tag, parse_only) if vop else []

    def flush(self, parse_only: bool = False) -> list:
        """The end of the stream: the last reference frame, if one waits."""
        return self._call(b"", -1, parse_only)

    def reset(self) -> None:
        self._lib.fvd_reset(self._h)

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) from the VOL, (0, 0) before one was read."""
        self._lib.fvd_info(self._h, self._info)
        return self._info[0], self._info[1]

    @property
    def stats(self) -> dict:
        """What the stream has used so far: VOP and macroblock counts by
        kind, and its tools (`STATS`)."""
        self._lib.fvd_info(self._h, self._info)
        return dict(zip(STATS, self._info[2:]))

    def close(self) -> None:
        if self._h:
            self._lib.fvd_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def planes_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Y / Cb / Cr 4:2:0 planes -> uint8 RGB [h, w, 3], as swscale's unscaled
    yuv420p -> BGR converter gives it to cv2's ``VideoCapture`` on x86
    (BT.601 limited range, each chroma sample over its 2 x 2 pixels, its
    16-bit fixed point); bit-equal to cv2's frames on every committed
    fixture."""
    h, w = y.shape
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    if cb.shape != ((h + 1) // 2, (w + 1) // 2) or cr.shape != cb.shape:
        raise ValueError(f"chroma planes {cb.shape} / {cr.shape} do not match Y {y.shape}")
    rgb = np.empty((h, w, 3), np.uint8)
    decoder_library().fvd_rgb(y.ctypes.data, cb.ctypes.data, cr.ctypes.data, w, h,
                              rgb.ctypes.data)
    return rgb


def vop_types(sample: bytes) -> str:
    """The coding types of the VOPs in a sample, in order ('I', 'P', 'B',
    'S'; 'N' for a VOP with vop_coded 0 is not told apart here)."""
    out, pos = [], 0
    while True:
        pos = sample.find(b"\x00\x00\x01\xb6", pos)
        if pos < 0 or pos + 4 >= len(sample):
            return "".join(out)
        out.append("IPBS"[sample[pos + 4] >> 6])
        pos += 4


def stream_config(sample: bytes) -> bytes:
    """The headers before a sample's first GOV or VOP (VOS, VO, VOL, user
    data), as FFmpeg extracts a stream's extradata from its first packet
    where the container holds none; b"" where there are none."""
    pos = 0
    while True:
        pos = sample.find(b"\x00\x00\x01", pos)
        if pos < 0 or pos + 3 >= len(sample):
            return b""
        if sample[pos + 3] in (0xB3, 0xB6):
            return sample[:pos] if pos > 4 else b""
        pos += 3


class Mpeg4Video:
    """`avi.open_video`'s calls over an MPEG-4 Part 2 stream: ``samples``
    [(offset, size)] into ``data`` in decode order (empty ones are dropped
    frames), ``config`` the container's headers (b"": the first sample's,
    `stream_config`), ``frame_count`` the container's (AVI ``dwLength``,
    MP4 sample count), ``fps``.

    What cv2 5.0.0 (its FFmpeg backend) does, and so what the reader does:

    - frames come in display order: a B-VOP where it is decoded, an I/P-VOP
      once the next I/P-VOP is (at once in a low-delay stream), the last
      at the end; an N-VOP (vop_coded 0), an empty chunk and the
      placeholder after a packed (P + B) chunk give no frame; so the read
      loop's count (`walk_count`) is the VOPs shown, which the
      container's count may exceed;
    - frame i is the i-th in that order: ``read_at(i)`` decodes from the
      last I-VOP shown at or before i (B-VOPs decoded after it but shown
      before it are skipped, as FFmpeg skips them without a reference)
      and keeps the decoder, so that ascending reads decode each sample
      once;
    - a seek is clamped to the frame count; one past the frames shown
      reads nothing (None); with a count of 0 or 1 a seek does not move;
    - in an AVI whose first chunk is empty the reader refuses to seek
      (``refuse_seek``), as for Motion-JPEG.

    A tool the decoder does not port that only the picture data shows
    (GMC parameters out of FFmpeg's range, DivX interlaced half-pel chroma,
    GMC video packets with a header extension; the header-only pass at open
    shows the rest) hands the file to cv2's ``VideoCapture`` from the read
    that meets it on, where cv2 imports (``reader`` becomes "cv2"); else
    that read raises NotImplementedError naming item 11.
    """

    reader = "port"

    def __init__(self, path: str, data: bytes, samples: list[tuple[int, int]], config: bytes,
                 fourcc: str, frame_count: int, fps: float, refuse_seek: str | None = None):
        self.path, self.fourcc, self.frame_count, self.fps = path, fourcc, frame_count, fps
        self._data = data
        self._samples = samples
        self._refuse = refuse_seek
        if not config:
            config = next((c for c in (stream_config(self._sample(k)) for k in
                                       range(len(samples))) if c), b"")
        self._config = config
        # the frame order: a header-only pass from the start
        probe = Mpeg4Decoder(config, fourcc, path)
        self._order: list[int] = []  # the tag of each frame shown
        for k in range(len(samples)):
            self._order += probe.decode(self._sample(k), k, parse_only=True)
        self._order += probe.flush(parse_only=True)
        self.width, self.height = probe.size
        probe.close()
        self._shown = {tag: i for i, tag in enumerate(self._order)}
        # decode starts: samples whose first VOP is an I-VOP, by where it shows
        self._starts = sorted((self._shown[k], k) for k in range(len(samples))
                              if k in self._shown and vop_types(self._sample(k))[:1] == "I")
        self._dec: Mpeg4Decoder | None = None
        self._cv2 = None  # cv2's reader, after a tool the decoder does not port
        self._next_sample = 0  # the next sample the live decoder takes
        self._next_shown = 0  # the frame its next output is
        self._pos = 0  # the next frame a read gets

    def _sample(self, k: int) -> bytes:
        off, size = self._samples[k]
        return self._data[off:off + size]

    def _start(self, i: int) -> None:
        """Point the live decoder at the last I-VOP shown at or before frame i."""
        starts = [s for s in self._starts if s[0] <= i]
        if not starts:
            raise ValueError(f"no I-VOP at or before frame {i}: {self.path}")
        shown, k = starts[-1]
        if self._dec is None:
            self._dec = Mpeg4Decoder(self._config, self.fourcc, self.path)
        else:
            self._dec.reset()
        self._next_sample, self._next_shown = k, shown

    def planes(self, i: int) -> YUVFrame:
        """Frame i of the frames shown (0 <= i < `walk_count`), its planes.
        A stream error raises, and the next read starts a fresh decoder."""
        try:
            return self._planes(i)
        except (ValueError, NotImplementedError):
            if self._dec is not None:
                self._dec.close()
                self._dec = None
            raise

    def _planes(self, i: int) -> YUVFrame:
        live = self._dec is not None and self._next_shown <= i
        better = [s for s in self._starts if self._next_shown < s[0] <= i]
        if not live or better:
            self._start(i)
        while True:
            if self._next_sample < len(self._samples):
                k = self._next_sample
                self._next_sample += 1
                out = self._dec.decode(self._sample(k), k)
            elif self._next_sample == len(self._samples):
                self._next_sample += 1
                out = self._dec.flush()
            else:
                raise ValueError(f"frame {i} was not decoded: {self.path}")
            for frame in out:
                j = self._shown.get(frame.tag)
                if j != self._next_shown:
                    raise ValueError(f"frame {self._next_shown} decoded out of order "
                                     f"(tag {frame.tag}): {self.path}")
                self._next_shown += 1
                if j == i:
                    return frame

    def decode(self, i: int) -> np.ndarray:
        """Frame i of the frames shown, RGB uint8 HWC."""
        if self._cv2 is None:
            try:
                f = self.planes(i)
                return planes_to_rgb(f.y, f.cb, f.cr)
            except NotImplementedError:
                from .avi import _Cv2Video, import_cv2

                cv2 = import_cv2()
                if cv2 is None:
                    raise
                self._cv2, self.reader = _Cv2Video(self.path, cv2), "cv2"
        frame = self._cv2.frame(i)
        if frame is None:
            raise ValueError(f"cv2 read no frame {i}: {self.path}")
        return frame

    @property
    def stats(self) -> dict:
        """The decoder's counts of the stream's tools so far (`Mpeg4Decoder.stats`)."""
        return self._dec.stats if self._dec is not None else {}

    def refusal(self) -> str | None:
        """Why seeks are refused in this file (an AVI whose first chunk is
        empty), or None."""
        return self._refuse

    def _refuse_seek(self) -> None:
        if self._refuse:
            raise ValueError(self._refuse)

    def read_at(self, i: int) -> np.ndarray | None:
        """``cap.set(CAP_PROP_POS_FRAMES, i); cap.read()`` as cv2 5.0.0 does
        it (see the class docstring)."""
        if self.frame_count > 1:
            self._refuse_seek()
            self._pos = min(max(int(i), 0), self.frame_count)
        if self._pos >= len(self._order):
            return None
        self._pos += 1
        return self.decode(self._pos - 1)

    def walk_count(self) -> int:
        """``set(CAP_PROP_POS_FRAMES, 0)``, then the frames a read loop gets."""
        if self.frame_count > 1:
            self._refuse_seek()
            self._pos = 0
        n, self._pos = len(self._order) - self._pos, len(self._order)
        return max(n, 0)

    def frames(self):
        """Every frame shown, in order, RGB uint8 HWC (a read loop from the
        start)."""
        for i in range(len(self._order)):
            yield self.decode(i)

    def release(self) -> None:
        if self._dec is not None:
            self._dec.close()
            self._dec = None
        if self._cv2 is not None:
            self._cv2.release()
        self._data = b""
