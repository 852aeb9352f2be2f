"""Port ops vs the JAX package on the same seeded inputs: box conversions,
grid, the IoU family, decode, normalize, letterbox and scale_coords.

Tolerances:
  - box / grid / IoU: atol 1e-6, rtol 1e-5 (float32, same formulas in the
    same order; transcendental functions (atan) may differ in the last ulp);
  - decode v5/v3: atol 1e-5 with rtol 1e-6 (sigmoid/exp implementations
    differ by ulps; decoded wh reach ~1500 px, where one float32 ulp is
    1.2e-4, so a bare 1e-5 atol holds only below 128 px);
  - normalize_images: exact (one cast and one division);
  - letterbox: same shape, scale and pad, pixels within +-1 (cv2 resizes
    with fixed-point weights, the port with float bilinear);
  - scale_coords: atol 1e-4.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.data.dataset import letterbox as jax_letterbox
from fastvision_tpu.data.pipeline import normalize_images as jax_normalize
from fastvision_tpu.infer.decode import decode_predictions as jax_decode
from fastvision_tpu.infer.postprocess import scale_coords as jax_scale_coords
from fastvision_tpu.ops import box as jbox
from fastvision_tpu.ops import iou as jiou
from fastvision_tpu.ops.anchors import COCO_ANCHORS as JAX_COCO_ANCHORS
from fastvision_tpu.ops.grid import grid as jax_grid
from fastvision_tpu_torch.data import letterbox, normalize_images
from fastvision_tpu_torch.infer import decode_predictions, scale_coords
from fastvision_tpu_torch.ops import COCO_ANCHORS, box, grid, iou

torch.set_num_threads(2)
ATOL, RTOL = 1e-6, 1e-5


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _boxes(rng, n, fmt="xyxy"):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(1, 40, (n, 2))
    if fmt == "xywh":
        return np.concatenate([xy, wh], -1).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["xywh2xyxy", "xyxy2xywh", "box_area"])
def test_box_conversions(name, rng):
    b = _boxes(rng, 50)
    _close(getattr(box, name)(torch.from_numpy(b)), getattr(jbox, name)(jnp.asarray(b)))


def test_box_normalized_roundtrip_and_clip(rng):
    b = _boxes(rng, 50) * 3 - 20
    _close(box.xyxy2xywhn(torch.from_numpy(b), 120.0, 160.0),
           jbox.xyxy2xywhn(jnp.asarray(b), 120.0, 160.0))
    n = rng.uniform(0, 1, (30, 4)).astype(np.float32)
    _close(box.xywhn2xyxy(torch.from_numpy(n), 120.0, 160.0),
           jbox.xywhn2xyxy(jnp.asarray(n), 120.0, 160.0))
    _close(box.clip_boxes(torch.from_numpy(b), 120.0, 160.0),
           jbox.clip_boxes(jnp.asarray(b), 120.0, 160.0))


@pytest.mark.parametrize("mode", ["xy", "yx"])
def test_grid(mode):
    _close(grid(5, 7, mode=mode), jax_grid(5, 7, mode=mode))


@pytest.mark.parametrize("fmt", ["xyxy", "xywh"])
@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_box_iou_family(kind, fmt, rng):
    a, b = _boxes(rng, 40, fmt), _boxes(rng, 40, fmt)
    _close(iou.box_iou(torch.from_numpy(a), torch.from_numpy(b), kind=kind, fmt=fmt),
           jiou.box_iou(jnp.asarray(a), jnp.asarray(b), kind=kind, fmt=fmt))
    _close(iou.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b[:25]), kind=kind, fmt=fmt),
           jiou.box_iou_matrix(jnp.asarray(a), jnp.asarray(b[:25]), kind=kind, fmt=fmt))


def test_wh_iou_and_aliases(rng):
    a = rng.uniform(1, 50, (20, 2)).astype(np.float32)
    b = rng.uniform(1, 50, (9, 2)).astype(np.float32)
    _close(iou.wh_iou(a[:9], b), jiou.wh_iou(a[:9], b))
    _close(iou.wh_iou_matrix(a, b), jiou.wh_iou_matrix(a, b))
    _close(iou.cal_iou_batch(a, b, mode="wh"), jiou.cal_iou_batch(a, b, mode="wh"))
    x, y = _boxes(rng, 20), _boxes(rng, 20)
    _close(iou.cal_iou(x, y), jiou.cal_iou(x, y))
    _close(iou.cal_iou_batch(x, y, mode="xyxy"), jiou.cal_iou_batch(x, y, mode="xyxy"))


def test_coco_anchors_copied():
    np.testing.assert_array_equal(COCO_ANCHORS, JAX_COCO_ANCHORS)


@pytest.mark.parametrize("style", ["v5", "v3"])
def test_decode_matches_jax(style, rng):
    heads = [rng.normal(0, 1.5, (2, s, s, 3, 9)).astype(np.float32) for s in (2, 4, 8)]
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    want = jax_decode([jnp.asarray(h) for h in heads], jnp.asarray(anchors), (32, 16, 8), style)
    got = decode_predictions([torch.from_numpy(h) for h in heads], anchors, (32, 16, 8), style)
    assert tuple(got.shape) == want.shape == (2, 3 * (4 + 16 + 64), 9)
    _close(got, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("imagenet", [False, True])
def test_normalize_images_exact(imagenet, rng):
    x = rng.integers(0, 256, (2, 5, 6, 3)).astype(np.uint8)
    got = normalize_images(torch.from_numpy(x), torch.float32, imagenet=imagenet)
    want = jax_normalize(jnp.asarray(x), jnp.float32, imagenet=imagenet)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_normalize_rejects_non_rgb():
    with pytest.raises(ValueError):
        normalize_images(torch.zeros(2, 6, 4, dtype=torch.uint8))


@pytest.mark.parametrize("hw", [(100, 80), (80, 100), (64, 64), (30, 50), (417, 333)])
def test_letterbox_matches_cv2_within_one(hw, rng):
    img = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    got, scale, pad = letterbox(img, 64)
    want, wscale, wpad = jax_letterbox(img, 64)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert scale == wscale and pad == wpad
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_scale_coords_matches_jax(rng):
    b = _boxes(rng, 30) * 4
    for scale, pad, hw in ((0.32, (0, 16), (100, 200)), ((0.5, 0.4), (3, 7), (300, 250))):
        _close(scale_coords(b, scale, pad, hw), jax_scale_coords(b, scale, pad, hw),
               atol=1e-4, rtol=0)


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, pulls in neither
    JAX nor the JAX package."""
    import fastvision_tpu_torch

    root = os.path.dirname(fastvision_tpu_torch.__file__)
    mods = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), os.path.dirname(root))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    mods.append("chip_smoke")
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'fastvision_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(" f"{sorted(mods)!r}" "))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(root), os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) >= 20
