"""An MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile intra-only video
encoder, the port's writer of annotated videos (`data.mp4.VideoWriter`
muxes its frames into an ``mp4v`` ``.mp4``, the file cv2's ``mp4v``
``VideoWriter`` writes in the JAX package).

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
"""
from __future__ import annotations

import ctypes
import math
from fractions import Fraction

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

    def reconstruct(self, levels: np.ndarray) -> np.ndarray:
        """Levels -> the uint8 RGB frame they decode to (a float IDCT; a
        decoder's integer IDCT may differ by one level)."""
        pix = np.clip(np.rint(DCT.T @ dequantize(levels, self.quant) @ DCT), 0, 255)
        return yuv420_to_rgb(*_planes(pix.astype(np.uint8), self.mb_h, self.mb_w),
                             self.height, self.width)

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
