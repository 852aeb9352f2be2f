"""Which corrupt JPEGs decode otherwise than cv2, and why (not collected by
pytest: run it by hand from the repo root).

    python tests/torch_jpeg_overflow_probe.py [seed] [files]

libjpeg-turbo's x86 SIMD ISLOW IDCT computes in 16-bit lanes: the
dequantization product wraps (pmullw) and the first pass's outputs
saturate (packssdw). Valid data never leaves 16 bits there; corrupt data
can, and there the port's exact integer IDCT differs from cv2. This builds
a copy of ``csrc/jpeg_decode.cpp`` that counts the blocks reaching either
(a dequantized coefficient, or a first-pass output, outside int16), decodes
``files`` seeded mutations (1-3 bit flips in the entropy-coded data of
cv2-written sequential / progressive files and arithmetic-coded ones, with
and without restart intervals) on the file route, and sorts each against
``cv2.imread``: equal; different with such a block; different without one
(a fault of the port's recovery). Needs cv2 and the host compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def build_probe(out_dir: str) -> ctypes.CDLL:
    from fastvision_tpu_torch import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, "jpeg_decode.cpp")) as f:
        src = f.read()
    count = '''int g_blocks = 0;
inline bool leaves_16_bits(int64_t v) { return v > 32767 || v < -32768; }
'''
    head = "void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {"
    dc = "      int dc = int(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));"
    rows = "  for (int r = 0; r < 8; ++r) {"
    for needle in (head, dc, rows):
        assert needle in src, needle
    src = src.replace(head, count + head + '''
  bool wide = false;
  for (int k = 0; k < 64; ++k) wide = wide || leaves_16_bits(int64_t(in[k]) * q[k]);''', 1)
    src = src.replace(dc, dc + "\n      wide = wide || leaves_16_bits(dc);", 1)
    at = src.index(rows, src.index(head))
    src = src[:at] + '''  for (int k = 0; k < 64; ++k) wide = wide || leaves_16_bits(ws[k]);
  g_blocks += wide;
''' + src[at:]
    src = src.replace('extern "C" {', 'extern "C" {\nint fvj_wide_blocks() { int n = g_blocks; '
                      'g_blocks = 0; return n; }', 1)
    path = os.path.join(out_dir, "probe.cpp")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, "probe.so")
    subprocess.run([cuda_build.host_compiler(), *cuda_build.HOST_FLAGS, "-o", lib, path],
                   check=True)
    dll = ctypes.CDLL(lib)
    i64, c_int, ptr, s = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
    dll.fvj_dims_reduced.argtypes = [s, i64, c_int, c_int, ctypes.POINTER(ctypes.c_int32), s,
                                     c_int]
    dll.fvj_decode_reduced.argtypes = [s, i64, c_int, c_int, ptr, i64, s, c_int]
    return dll


def decode_counting(dll, data: bytes):
    """The file route's full-size decode (or None) and the blocks it ran
    whose arithmetic leaves 16 bits."""
    dll.fvj_wide_blocks()
    dims, err = (ctypes.c_int32 * 2)(), ctypes.create_string_buffer(256)
    if dll.fvj_dims_reduced(data, len(data), 1, 1, dims, err, 256):
        return None, 0
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    if dll.fvj_decode_reduced(data, len(data), 1, 1, out.ctypes.data, out.nbytes, err, 256):
        return None, dll.fvj_wide_blocks()
    return out, dll.fvj_wide_blocks()


def sources() -> list[bytes]:
    import cv2

    from fastvision_tpu_torch import testing

    dqt, dht = testing.standard_jpeg_tables(90)
    out = []
    for k in range(6):
        img = testing._scene(64, 96, 100 + k)
        params = [cv2.IMWRITE_JPEG_QUALITY, 50 + 8 * k, cv2.IMWRITE_JPEG_RST_INTERVAL, k % 3]
        out.append(cv2.imencode(".jpg", img, params + ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
                                                       if k % 2 else []))[1].tobytes())
        out.append(testing.encode_progressive_jpeg(img, dqt, dht, progressive=bool(k % 2),
                                                   arithmetic=True, restart=k % 3))
    return out


def main(seed: int = 0, files: int = 900) -> dict:
    import cv2

    rng = np.random.default_rng(seed)
    counts = dict(equal=0, equal_with_wide_blocks=0, differ_with_wide_blocks=0,
                  differ_without=0, no_image_either=0, no_image_one=0)
    with tempfile.TemporaryDirectory() as d:
        dll = build_probe(d)
        srcs = sources()
        for i in range(files):
            buf = bytearray(srcs[i % len(srcs)])
            sos = buf.index(b"\xff\xda")
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(sos + 14, len(buf) - 2))
                new = buf[at] ^ (1 << int(rng.integers(8)))
                if 0xFF not in (new, buf[at], buf[at - 1], buf[at + 1]):
                    buf[at] = new
            path = os.path.join(d, f"{i}.jpg")
            with open(path, "wb") as f:
                f.write(bytes(buf))
            want = cv2.imread(path, cv2.IMREAD_COLOR)
            got, wide = decode_counting(dll, bytes(buf))
            if want is None or got is None:
                counts["no_image_either" if want is None and got is None else "no_image_one"] += 1
            elif np.array_equal(got, want[..., ::-1]):
                counts["equal_with_wide_blocks" if wide else "equal"] += 1
            else:
                counts["differ_with_wide_blocks" if wide else "differ_without"] += 1
    return counts


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    print(main(*args))
