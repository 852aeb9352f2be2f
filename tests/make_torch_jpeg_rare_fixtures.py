"""Writes the arithmetic-coded and lossless JPEG fixtures of
``tests/torch_codec_fixtures/`` (``arith_*``, ``lossless_*``, ``sof1_*``) and
adds them, with cv2's decodes, to its ``manifest.json`` and
``cv2_decodes.npz`` (not collected by pytest: run it by hand, then rewrite
the oracles of the fused and reduced decodes).

    python tests/make_torch_jpeg_rare_fixtures.py
    PYTHONPATH=. python tests/test_torch_i420.py --write

The files come from independent encoders, built here with ``gcc`` into a
temporary directory from the small C programs below:

- the system libjpeg-turbo 2.1.5 (``jpeglib.h``, ``-ljpeg``) writes the
  arithmetic-coded files: ``arith_code = TRUE``, sequential (SOF9) or
  ``jpeg_simple_progression`` (SOF10), restart intervals, the DAC
  conditioning (``arith_dc_L`` / ``arith_dc_U`` / ``arith_ac_K``), gray,
  CMYK and YCCK;
- GDCM's IJG builds (``gdcmjpeg/{8,12,16}`` headers,
  ``libgdcmjpeg{8,12,16}.so.3.0``) write the lossless files
  (``jpeg_simple_lossless(predictor, point transform)``; restarts only by
  whole rows) and the 12-bit ones.

Each decodable file's entry holds cv2 5.0's ``IMREAD_COLOR`` decode (shape,
sha256; the pixels go into ``cv2_decodes.npz``). The files cv2 returns no
image for (YCbCr-tagged, YCCK and gray lossless, 12-bit, 12- and 16-bit
lossless; GDCM's 8-bit build refuses 2- to 7-bit samples, which the tests
write themselves) and the two corrupt arithmetic streams carry the message the
port's decoder raises with; the script asserts what cv2 gives for each.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from fastvision_tpu_torch.data import codec  # noqa: E402
from fastvision_tpu_torch.testing import _scene  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_codec_fixtures")
PREFIXES = ("arith_", "lossless_", "sof1_")
GDCM = "/usr/include/gdcm-3.0/gdcmjpeg"

# in.raw out.jpg W H C [key=value ...]: samples (JSAMPLE, interleaved) -> a JPEG
WRITER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "jpeglib.h"
static int arg(int argc, char** argv, const char* k, int d) {
  size_t n = strlen(k);
  for (int i = 6; i < argc; ++i)
    if (!strncmp(argv[i], k, n) && argv[i][n] == '=') return atoi(argv[i] + n + 1);
  return d;
}
int main(int argc, char** argv) {
  int W = atoi(argv[3]), H = atoi(argv[4]), C = atoi(argv[5]);
  size_t bytes = (size_t)W * H * C * sizeof(JSAMPLE);
  JSAMPLE* px = malloc(bytes);
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, bytes, f) != bytes) return 2;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* o = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, o);
  c.image_width = W;
  c.image_height = H;
  c.input_components = C;
  c.in_color_space = C == 1 ? JCS_GRAYSCALE : C == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
#ifdef LOSSLESS
  int pred = arg(argc, argv, "pred", 0);
  if (pred) jpeg_simple_lossless(&c, pred, arg(argc, argv, "pt", 0));
  else
#endif
  jpeg_set_quality(&c, arg(argc, argv, "q", 90), FALSE);
  int cs = arg(argc, argv, "cs", -1);  /* the J_COLOR_SPACE to write */
  if (cs >= 0) jpeg_set_colorspace(&c, (J_COLOR_SPACE)cs);
  int samp = arg(argc, argv, "samp", 0);  /* luma (and K) sampling, 10 h + v */
  if (samp) {
    c.comp_info[0].h_samp_factor = samp / 10;
    c.comp_info[0].v_samp_factor = samp % 10;
    if (C == 4) {
      c.comp_info[3].h_samp_factor = samp / 10;
      c.comp_info[3].v_samp_factor = samp % 10;
    }
  }
  c.restart_interval = arg(argc, argv, "rst", 0);
  c.restart_in_rows = arg(argc, argv, "rstrows", 0);
#ifndef LOSSLESS
  c.arith_code = arg(argc, argv, "arith", 0);
  for (int t = 0; t < 2; ++t) {
    c.arith_dc_L[t] = arg(argc, argv, "L", 0);
    c.arith_dc_U[t] = arg(argc, argv, "U", 1);
    c.arith_ac_K[t] = arg(argc, argv, "K", 5);
  }
  if (arg(argc, argv, "prog", 0)) jpeg_simple_progression(&c);
#endif
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW r = px + (size_t)c.next_scanline * W * C;
    jpeg_write_scanlines(&c, &r, 1);
  }
  jpeg_finish_compress(&c);
  fclose(o);
  jpeg_destroy_compress(&c);
  return 0;
}
"""
JCS_RGB, JCS_YCBCR, JCS_CMYK, JCS_YCCK = 2, 3, 4, 5


def build(tmp: str) -> dict:
    src = os.path.join(tmp, "writer.c")
    with open(src, "w") as f:
        f.write(WRITER)
    tools = {"libjpeg": ["-ljpeg"]}
    tools.update({f"gdcm{b}": ["-DLOSSLESS", f"-I{GDCM}/{b}", f"-l:libgdcmjpeg{b}.so.3.0"]
                  for b in (8, 12, 16)})
    out = {}
    for name, flags in tools.items():
        exe = os.path.join(tmp, name)
        subprocess.run(["gcc", "-O1", "-o", exe, src, *flags], check=True)
        out[name] = exe
    return out


def write(tools: dict, tmp: str, tool: str, samples: np.ndarray, **kw) -> bytes:
    h, w = samples.shape[:2]
    c = 1 if samples.ndim == 2 else samples.shape[2]
    raw, jpg = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
    samples.tofile(raw)
    subprocess.run([tools[tool], raw, jpg, str(w), str(h), str(c),
                    *(f"{k}={v}" for k, v in kw.items())], check=True)
    with open(jpg, "rb") as f:
        return f.read()


def cv2_rgb(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])


def noise(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def libjpeg_warnings(data: bytes) -> str:
    """What libjpeg writes to the standard error while cv2.imdecode decodes
    ``data`` (its warnings, e.g. "Corrupt JPEG data: bad arithmetic code")."""
    import tempfile

    with tempfile.TemporaryFile() as log:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(log.fileno(), 2)
        try:
            cv2_rgb(data)
        finally:
            os.dup2(saved, 2)
            os.close(saved)
        log.seek(0)
        return log.read().decode(errors="replace")


def bad_code_stream(data: bytes, seed: int) -> bytes:
    """``data`` with seeded byte changes in its entropy-coded segment until
    libjpeg warns of a bad arithmetic code and cv2 returns an image."""
    rng = np.random.default_rng(seed)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    for _ in range(10000):
        b = bytearray(data)
        for _ in range(3):
            b[int(rng.integers(start, len(data) - 2))] = int(rng.integers(0, 255))  # never 0xFF
        if "bad arithmetic code" in libjpeg_warnings(bytes(b)) and cv2_rgb(bytes(b)) is not None:
            return bytes(b)
    raise RuntimeError("no bad-code stream found")


def fixtures(tools: dict, tmp: str) -> list:
    """-> [(name, bytes, features, raises or None)]"""
    def arith(img, **kw):
        return write(tools, tmp, "libjpeg", img, arith=1, **kw)

    def lossless(img, bits=8, **kw):
        return write(tools, tmp, f"gdcm{bits}", img, **kw)

    files = []
    for name, img, kw, what in (
            ("arith_seq_420_37x53", _scene(37, 53, 400), dict(samp=22), "4:2:0 q90"),
            ("arith_seq_422_rst_dac_45x61", _scene(45, 61, 401),
             dict(samp=21, rst=3, L=1, U=3, K=9, q=85), "4:2:2, restart 3, DAC L 1 U 3 Kx 9"),
            ("arith_seq_444_noise_q95_29x41", noise(402, 29, 41), dict(samp=11, q=95),
             "4:4:4 q95, noise"),
            ("arith_seq_411_33x70", _scene(33, 70, 403), dict(samp=41), "4:1:1"),
            ("arith_seq_440_rst_dac_39x27", _scene(39, 27, 404),
             dict(samp=12, rst=1, L=2, U=5, K=2), "4:4:0, restart 1, DAC L 2 U 5 Kx 2"),
            ("arith_seq_gray_30x41", _scene(30, 41, 405)[..., 1], {}, "gray"),
            ("arith_prog_420_47x66", _scene(47, 66, 406), dict(samp=22, prog=1),
             "progressive (libjpeg's simple script) 4:2:0"),
            ("arith_prog_422_rst_41x57", _scene(41, 57, 407), dict(samp=21, prog=1, rst=2),
             "progressive 4:2:2, restart 2"),
            ("arith_prog_444_noise_q100_25x31", noise(408, 25, 31), dict(samp=11, prog=1, q=100),
             "progressive 4:4:4 q100, noise"),
            ("arith_prog_gray_rst_38x53", _scene(38, 53, 409)[..., 0], dict(prog=1, rst=4),
             "progressive gray, restart 4"),
            ("arith_seq_cmyk_35x49", noise(410, 35, 49, 4), dict(samp=11, cs=JCS_CMYK),
             "CMYK (Adobe transform 0)"),
            ("arith_prog_ycck_35x49",
             np.concatenate([_scene(35, 49, 411), _scene(35, 49, 412)[..., :1]], -1),
             dict(samp=22, cs=JCS_YCCK, prog=1),
             "progressive YCCK (Adobe transform 2), Y and K 2x2")):
        files.append((name + ".jpg", arith(img, **kw), "libjpeg arithmetic " + what, None))
    whole = arith(_scene(48, 64, 413), samp=22, rst=2)
    files.append(("arith_truncated.jpg", whole[:len(whole) * 2 // 3],
                  "must raise: arithmetic, cut at 2/3 without EOI (cv2 returns None)",
                  "truncated JPEG data"))
    files.append(("arith_bad_code.jpg", bad_code_stream(arith(_scene(40, 56, 414), samp=22), 414),
                  "arithmetic with corrupt bytes, a bad code (libjpeg warns: the rest of the "
                  "scan is left zero)", None))
    for name, img, kw, what in (
            ("lossless_rgb_p1_37x53", _scene(37, 53, 420), dict(pred=1), "predictor 1"),
            ("lossless_rgb_p2_rst_29x41", _scene(29, 41, 421), dict(pred=2, rstrows=3),
             "predictor 2, restart every 3 rows"),
            ("lossless_rgb_p3_pt2_23x35", _scene(23, 35, 422), dict(pred=3, pt=2),
             "predictor 3, point transform 2"),
            ("lossless_rgb_p4_samp22_31x45", _scene(31, 45, 423), dict(pred=4, samp=22),
             "predictor 4, R sampled 2x2"),
            ("lossless_rgb_p5_samp21_rst_27x38", _scene(27, 38, 424),
             dict(pred=5, samp=21, rstrows=1), "predictor 5, R sampled 2x1, restart every row"),
            ("lossless_rgb_p6_pt1_rst_25x33", noise(425, 25, 33), dict(pred=6, pt=1, rstrows=2),
             "predictor 6, point transform 1, restart every 2 rows, noise"),
            ("lossless_rgb_p7_pt3_33x29", _scene(33, 29, 426), dict(pred=7, pt=3),
             "predictor 7, point transform 3"),
            ("lossless_cmyk_p1_21x30", noise(427, 21, 30, 4), dict(pred=1, cs=JCS_CMYK),
             "CMYK (Adobe transform 0), predictor 1"),
            ("lossless_cmyk_p6_pt2_rst_19x27", noise(428, 19, 27, 4),
             dict(pred=6, pt=2, rstrows=2, cs=JCS_CMYK),
             "CMYK, predictor 6, point transform 2, restart")):
        files.append((name + ".jpg", lossless(img, cs=kw.pop("cs", JCS_RGB), **kw),
                      "GDCM lossless (SOF3) RGB-coded (Adobe transform 0), " + what
                      if "cmyk" not in name else "GDCM lossless (SOF3) " + what, None))
    wide = (_scene(16, 20, 430).astype(np.uint16) << 4) | 7
    for name, data, what, raises in (
            ("lossless_ycbcr_p1_21x30.jpg", lossless(_scene(21, 30, 431), pred=1, cs=JCS_YCBCR),
             "YCbCr-tagged (JFIF)", "lossless YCbCr JPEG"),
            ("lossless_ycck_p1_17x23.jpg",
             lossless(noise(432, 17, 23, 4), pred=1, cs=JCS_YCCK), "YCCK (Adobe transform 2)",
             "lossless YCCK JPEG"),
            ("lossless_gray_p1_19x26.jpg", lossless(_scene(19, 26, 433)[..., 2], pred=1), "gray",
             "lossless gray JPEG"),
            ("sof1_12bit_20x30.jpg",
             lossless(_scene(20, 30, 434).astype(np.uint16) << 4, bits=12, q=90),
             "12-bit DCT (SOF1) YCbCr", "12-bit JPEG"),
            ("lossless_12bit_rgb_16x20.jpg", lossless(wide, bits=12, pred=1, cs=JCS_RGB),
             "12-bit lossless RGB-coded", "12-bit lossless JPEG"),
            ("lossless_16bit_rgb_16x20.jpg",
             lossless((_scene(16, 20, 435).astype(np.uint16) << 8) | 0x5A, bits=16, pred=1,
                      cs=JCS_RGB), "16-bit lossless RGB-coded", "16-bit lossless JPEG")):
        files.append((name, data, f"must raise: GDCM {what} (cv2 returns None)", raises))
    return files


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        tools = build(tmp)
        files = fixtures(tools, tmp)
    path = os.path.join(OUT, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["files"] = [e for e in manifest["files"] if not e["file"].startswith(PREFIXES)]
    with np.load(os.path.join(OUT, "cv2_decodes.npz")) as stored:
        decodes = {k: stored[k] for k in stored.files if not k.startswith(PREFIXES)}
    for name, data, features, raises in files:
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        entry = {"file": name, "features": features, "bytes": len(data)}
        rgb = cv2_rgb(data)
        if raises:
            assert rgb is None, f"cv2 decodes {name}"
            entry["raises"] = raises
        else:
            assert rgb is not None, f"cv2 cannot decode {name}"
            entry["shape"] = list(rgb.shape)
            entry["sha256"] = hashlib.sha256(rgb.tobytes()).hexdigest()
            decodes[name] = rgb
        manifest["files"].append(entry)
    manifest["rare_jpeg_written_with"] = {
        "arithmetic": "libjpeg-turbo 2.1.5 (libjpeg.so.62)",
        "lossless_and_12_bit": "GDCM 3.0.21's IJG 6b builds (libgdcmjpeg{8,12,16}.so.3.0)",
        "cv2": cv2.__version__}
    np.savez_compressed(os.path.join(OUT, "cv2_decodes.npz"), **decodes)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    total = sum(len(d) for _, d, _, _ in files)
    print(f"wrote {len(files)} files ({total} bytes) into {OUT}; now run "
          "PYTHONPATH=. python tests/test_torch_i420.py --write")


if __name__ == "__main__":
    main()
