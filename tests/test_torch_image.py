"""The port's ops/image.py against the JAX package's on the same seeded
inputs, on the CPU.

Tolerances: the device letterbox within 1e-4 (0-255 scale; both run float32
matmuls, which sum in other orders) with equal scales and pads; the I420 ->
RGB decode and `normalize_images`' packed branch within 1e-4; RGB -> I420
bit-equal to cv2's ``COLOR_RGB2YUV_I420`` (which the JAX package calls); the
canvas pre-shrink within 1 of cv2's ``INTER_AREA``; the flips equal.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.data.pipeline as jpipe
import fastvision_tpu.ops.image as jimage
from fastvision_tpu_torch.data import normalize_images
from fastvision_tpu_torch.ops import image as timage


def _smooth(rng, h, w):
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0)


@pytest.mark.parametrize("sizes,out_size", [
    (((48, 64), (64, 30), (17, 23)), 64),     # down- and up-scales, odd sizes
    (((100, 75), (33, 90), (64, 64)), 48),    # square, a size equal to the canvas
    (((7, 5), (90, 101), (50, 3)), 37),       # odd output size, extreme aspect
])
def test_letterbox_batch_matches_jax(sizes, out_size):
    rng = np.random.default_rng(out_size)
    hmax, wmax = max(h for h, _ in sizes), max(w for _, w in sizes)
    canvas = np.full((len(sizes), hmax, wmax, 3), 114, np.uint8)
    for i, (h, w) in enumerate(sizes):
        canvas[i, :h, :w] = _smooth(rng, h, w)
    sizes_hw = np.asarray(sizes, np.int32)
    want = [np.asarray(a) for a in jimage.letterbox_batch(jnp.asarray(canvas),
                                                          jnp.asarray(sizes_hw), out_size)]
    got = [t.numpy() for t in timage.letterbox_batch(torch.from_numpy(canvas),
                                                     torch.from_numpy(sizes_hw), out_size)]
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    assert np.abs(got[0] - want[0]).max() <= 1e-4
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    bf16 = timage.letterbox_batch(torch.from_numpy(canvas), torch.from_numpy(sizes_hw),
                                  out_size, pad_value=0.0, dtype=torch.bfloat16)[0]
    assert bf16.dtype == torch.bfloat16 and float(bf16.float().min()) >= 0.0


@pytest.mark.parametrize("s", [64, 416])
def test_rgb_to_i420_bit_equal_to_cv2(s):
    rng = np.random.default_rng(s)
    batch = rng.integers(0, 256, (3, s, s, 3), dtype=np.uint8)
    batch[1] = _smooth(rng, s, s)
    batch[2, : s // 2] = (0, 0, 0)
    batch[2, s // 2 :] = (255, 255, 255)
    packed = timage.rgb_batch_to_i420_packed(batch)
    np.testing.assert_array_equal(packed, jimage.rgb_batch_to_i420_packed(batch))
    for got, want in zip(timage.rgb_batch_to_i420(batch), jimage.rgb_batch_to_i420(batch)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        timage.rgb_batch_to_i420(batch[:, :-1])


def test_i420_to_rgb_and_normalize_match_jax():
    rng = np.random.default_rng(1)
    s = 48
    packed = jimage.rgb_batch_to_i420_packed(
        np.stack([_smooth(rng, s, s), rng.integers(0, 256, (s, s, 3), dtype=np.uint8)]))
    y = packed[:, :s]
    u = rng.integers(0, 256, (2, s // 2, s // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (2, s // 2, s // 2), dtype=np.uint8)
    want = np.asarray(jimage.i420_to_rgb(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
    got = timage.i420_to_rgb(*(torch.from_numpy(a) for a in (y, u, v))).numpy()
    assert np.abs(got - want).max() <= 1e-4
    want = np.asarray(jimage.i420_packed_to_rgb(jnp.asarray(packed)))
    got = timage.i420_packed_to_rgb(torch.from_numpy(packed)).numpy()
    assert got.shape == (2, s, s, 3) and np.abs(got - want).max() <= 1e-4
    for imagenet in (False, True):
        want = np.asarray(jpipe.normalize_images(jnp.asarray(packed), jnp.float32, imagenet))
        got = normalize_images(torch.from_numpy(packed), torch.float32, imagenet).numpy()
        assert np.abs(got - want).max() <= 1e-4
    with pytest.raises(ValueError, match="unbatched"):
        normalize_images(torch.zeros(s, s, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="packed I420"):
        timage.i420_packed_to_rgb(torch.zeros(2, s, s, dtype=torch.uint8))


def test_pack_canvas_and_flips_match_jax():
    rng = np.random.default_rng(2)
    arrs = [_smooth(rng, 30, 40), _smooth(rng, 90, 50), _smooth(rng, 41, 130),
            rng.integers(0, 256, (77, 77, 3), dtype=np.uint8)]
    got_c, got_s = timage.pack_canvas(arrs, 64, 64, pad_value=7)
    want_c, want_s = jimage.pack_canvas(arrs, 64, 64, pad_value=7)
    np.testing.assert_array_equal(got_s, want_s)  # pre-shrink sizes included
    assert np.abs(got_c.astype(int) - want_c).max() <= 1  # cv2 INTER_AREA within 1
    c, s = timage.pack_canvas(arrs[:1])
    assert c.shape == (1, 30, 40, 3) and (c[0] == arrs[0]).all() and s.tolist() == [[30, 40]]
    imgs = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timage.hflip_images(torch.from_numpy(imgs)).numpy(),
                                  np.asarray(jimage.hflip_images(jnp.asarray(imgs))))
    labels = np.array([[[0, 0.2, 0.3, 0.1, 0.2], [-1, 0.4, 0.5, 0.0, 0.0]]], np.float32)
    np.testing.assert_array_equal(timage.hflip_boxes_xywhn(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jimage.hflip_boxes_xywhn(jnp.asarray(labels))))
