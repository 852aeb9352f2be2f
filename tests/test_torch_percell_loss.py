"""Port's iou_loss, BCE on probabilities and YOLOv3LossPerCell vs the JAX
package on the CPU in float32: values and gradients w.r.t. the inputs.

Tolerances: losses rtol 1e-5 (float32 sums over a few hundred cells in a
different order); gradients max|port - jax| <= 1e-5 * std(jax grad).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.train import losses as jl
from fastvision_tpu_torch import train as ttrain
from fastvision_tpu_torch.train import losses as tl

torch.set_num_threads(2)
# YOLOv3's COCO anchors scaled to a 64 px input, deepest level first
ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]],
                    [[30, 61], [62, 45], [59, 119]],
                    [[10, 13], [16, 30], [33, 23]]], np.float32) * (64 / 416)
NUM_CLASSES = 4
SIZE = 64


def _close_grads(got, want):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * want.std()


def _boxes(rng, n, fmt):
    xy = rng.uniform(0, 10, (n, 2))
    wh = rng.uniform(0.3, 4, (n, 2))
    if fmt == "xywh":
        return np.concatenate([xy, wh], -1).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("fmt", ["xyxy", "xywh"])
@pytest.mark.parametrize("reduction", ["mean", "none", "weighted"])
def test_iou_loss_matches_jax(kind, fmt, reduction):
    rng = np.random.default_rng(0)
    pred, target = _boxes(rng, 48, fmt), _boxes(rng, 48, fmt)
    pred[:8] = target[:8]  # perfect overlaps
    w = rng.uniform(0, 1, 48).astype(np.float32) if reduction == "weighted" else None
    red = "mean" if reduction == "weighted" else reduction

    def jax_fn(p, t):
        return jl.iou_loss(p, t, kind=kind, fmt=fmt, reduction=red,
                           weights=None if w is None else jnp.asarray(w))

    want = jax_fn(jnp.asarray(pred), jnp.asarray(target))
    want_grad = jax.grad(lambda p: jnp.sum(jax_fn(p, jnp.asarray(target))))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = ttrain.iou_loss(tp, torch.from_numpy(target), kind=kind, fmt=fmt, reduction=red,
                          weights=None if w is None else torch.from_numpy(w))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    _close_grads(tp.grad.numpy(), want_grad)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_binary_cross_entropy_on_probabilities_matches_jax(reduction):
    """Probabilities clipped to [1e-8, 1 - 1e-8]; in float32 the upper clip
    is 1, so a probability of 1 is NaN (0 * log 0) or inf in both packages:
    the comparison takes NaN as equal to NaN."""
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 1, (6, 9)).astype(np.float32)
    p[0, :3] = (0.0, 1e-12, 0.5)
    t = rng.uniform(0, 1, (6, 9)).astype(np.float32)
    t[1, :2] = (0.0, 1.0)
    p[1, :2] = (0.0, 1.0)  # at the clips: finite, then NaN
    want = jl.binary_cross_entropy(jnp.asarray(p), jnp.asarray(t), from_logits=False,
                                   reduction=reduction)
    want_grad = jax.grad(lambda x: jnp.sum(jl.binary_cross_entropy(
        x, jnp.asarray(t), from_logits=False, reduction=reduction)))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_()
    got = ttrain.binary_cross_entropy(tp, torch.from_numpy(t), False, reduction=reduction)
    got.sum().backward()
    if reduction == "none":
        assert np.isfinite(got[1, 0].item()) and np.isnan(got[1, 1].item())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-5)
    # the logits path is unchanged by the new argument
    x = rng.normal(0, 3, (6, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        ttrain.binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        ttrain.binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(t), True).numpy())


def _labels():
    """Image 0: five GTs, two of them centred in one cell with one anchor
    shape; image 1: no GT (all padding)."""
    rng = np.random.default_rng(2)
    lab = np.full((2, 7, 5), -1, np.float32)
    lab[0, :5, 0] = rng.integers(0, NUM_CLASSES, 5)
    lab[0, :5, 1:3] = rng.uniform(0.1, 0.9, (5, 2))
    lab[0, :5, 3:5] = rng.uniform(0.05, 0.7, (5, 2))
    lab[0, 1, 1:5] = (0.52, 0.52, 0.3, 0.35)
    lab[0, 2, 1:5] = (0.53, 0.51, 0.31, 0.34)
    return lab


def _heads(seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (b, SIZE // s, SIZE // s, 3, 5 + NUM_CLASSES)).astype(np.float32)
            for s in (32, 16, 8)]


@pytest.mark.parametrize("box_loss", ["bce_mse", "ciou"])
@pytest.mark.parametrize("ignore_iou_thres", [0.5, 0.05])
def test_yolov3_loss_per_cell_and_grads_match_jax(box_loss, ignore_iou_thres):
    heads, labels = _heads(3), _labels()
    kw = dict(num_classes=NUM_CLASSES, box_loss=box_loss, ignore_iou_thres=ignore_iou_thres)
    jloss = jl.YOLOv3LossPerCell(ANCHORS, **kw)
    tloss = ttrain.YOLOv3LossPerCell(ANCHORS, **kw)
    (_, want), want_grads = jax.jit(jax.value_and_grad(
        lambda hs, lab: (jloss(hs, lab).total, jloss(hs, lab)), has_aux=True))(
        [jnp.asarray(h) for h in heads], jnp.asarray(labels))
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    got = tloss(th, torch.from_numpy(labels))
    got.total.backward()
    for name in ("total", "box", "obj", "cls"):
        np.testing.assert_allclose(float(getattr(got, name).detach()), float(getattr(want, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for g, w in zip(th, want_grads):
        assert np.isfinite(g.grad.numpy()).all()
        _close_grads(g.grad.numpy(), w)
    # the image with no GT trains objectness only: no box or class gradient
    for g in th:
        assert not g.grad[1, ..., :4].any() and not g.grad[1, ..., 5:].any()


def test_yolov3_loss_per_cell_ignore_mask_is_a_comparison():
    """The ignore mask is a bool that carries no gradient; the two GTs of
    `_labels` centred in one cell share a slot (fewer positives than GTs)."""
    heads, labels = _heads(4), _labels()
    loss = tl.YOLOv3LossPerCell(ANCHORS, num_classes=NUM_CLASSES, ignore_iou_thres=0.05)
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    t = tl._dense_targets(torch.from_numpy(labels), loss.anchors_feat(torch.device("cpu"))[0],
                          (2, 2))
    pred = torch.cat([torch.sigmoid(th[0][..., :2]), torch.exp(th[0][..., 2:4])], -1)
    mask = loss._ignore(pred, t)
    assert mask.dtype == torch.bool and not mask.requires_grad
    assert loss(th, torch.from_numpy(labels)).total.requires_grad
    assert float(t["pos"][0].sum()) == 4 and float(t["pos"][1].sum()) == 0


def test_yolov3_loss_per_cell_rejects_an_unknown_box_loss():
    with pytest.raises(ValueError, match="box_loss"):
        ttrain.YOLOv3LossPerCell(ANCHORS, box_loss="giou")
