"""Port's training losses vs the JAX package on the CPU in float32: the BN
running statistics in train mode, one_hot, BCE, the dense target assignment
and YOLOv3Loss (values and gradients w.r.t. every head).

Tolerances: losses rtol 1e-5 (float32 sums over a few thousand cells in a
different order); gradients max|port - jax| <= 1e-5 * std(jax grad);
targets exact (they are integer cell arithmetic and copies of the labels);
BN running variance 1e-6 relative, well below the 0.3% of the update by
which an unbiased variance (n / (n - 1), n = 338) would move it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.nn.layers import ConvBN as JaxConvBN
from fastvision_tpu.ops.one_hot import one_hot as jax_one_hot
from fastvision_tpu.train import losses as jl
from fastvision_tpu_torch.models.import_jax import _convbn
from fastvision_tpu_torch.nn import ConvBN
from fastvision_tpu_torch.ops import box_iou, one_hot
from fastvision_tpu_torch.train import losses as tl

torch.set_num_threads(2)
ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]],
                    [[30, 61], [62, 45], [59, 119]],
                    [[10, 13], [16, 30], [33, 23]]], np.float32) / 4
NUM_CLASSES = 3
SIZE = 128


def _labels(seed, b=2, m=8, n_real=5, num_classes=NUM_CLASSES, lo=0.05, hi=0.5):
    rng = np.random.default_rng(seed)
    lab = np.full((b, m, 5), -1, np.float32)
    lab[:, :n_real, 0] = rng.integers(0, num_classes, (b, n_real))
    lab[:, :n_real, 1:3] = rng.uniform(0.05, 0.95, (b, n_real, 2))
    lab[:, :n_real, 3:5] = rng.uniform(lo, hi, (b, n_real, 2))
    return lab


def _heads(seed, b=2, size=SIZE, c=NUM_CLASSES):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (b, size // s, size // s, 3, 5 + c)).astype(np.float32)
            for s in (32, 16, 8)]


def test_bn_running_statistics_match_flax():
    """One train-mode forward of a ConvBN at batch 2 on 13x13: flax folds the
    BIASED batch variance into running_var; torch's own BatchNorm2d folds in
    the unbiased one."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (2, 13, 13, 4)).astype(np.float32)
    jm = JaxConvBN(6, 3, 1)
    variables = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(x)))
    y_jax, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    sd = {}
    _convbn(sd, "m", variables["params"], variables["batch_stats"])
    tm = ConvBN(4, 6, 3)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    y = tm.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = upd["batch_stats"]["bn"]["bn"]
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(want["var"]), rtol=1e-6)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(want["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_jax), rtol=1e-5, atol=1e-5)


def test_bn_momentum_none_is_a_cumulative_average():
    bn = torch.nn.Sequential(ConvBN(3, 4, 1)).train()[0].bn
    bn.momentum = None
    x = torch.randn(2, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    bn.reset_running_stats()
    bn(x)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               x.var(dim=(0, 2, 3), unbiased=False).numpy(), rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def test_one_hot_matches_jax():
    labels = np.array([[0, 2, -1], [4, 1, 3]], np.int32)
    got = one_hot(torch.from_numpy(labels), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_one_hot(jnp.asarray(labels), 4)))
    assert got.dtype == torch.float32 and one_hot(torch.tensor([1]), 3, torch.bool).dtype == torch.bool


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_cross_entropy_matches_jax(reduction, weighted):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (4, 7)).astype(np.float32)
    t = rng.uniform(0, 1, (4, 7)).astype(np.float32)
    w = rng.uniform(0, 1, (4, 7)).astype(np.float32) if weighted else None
    want = jl.binary_cross_entropy(jnp.asarray(x), jnp.asarray(t),
                                   weights=None if w is None else jnp.asarray(w),
                                   reduction=reduction)
    got = tl.binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(t),
                                  weights=None if w is None else torch.from_numpy(w),
                                  reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ratio_thres", [4.0, None], ids=["ratio", "best_anchor"])
@pytest.mark.parametrize("neighbor_cells", [False, True])
def test_dense_targets_match_jax(ratio_thres, neighbor_cells, level=1):
    """Collision-free labels (one GT per image quadrant cell pattern) give
    the same dense targets, element for element."""
    rng = np.random.default_rng(2)
    labels = np.full((2, 6, 5), -1, np.float32)
    # four GTs per image on a 2x2 grid of well separated centres
    centres = np.array([[0.2, 0.2], [0.7, 0.25], [0.3, 0.75], [0.8, 0.8]], np.float32)
    labels[:, :4, 0] = rng.integers(0, NUM_CLASSES, (2, 4))
    labels[:, :4, 1:3] = centres + rng.uniform(-0.04, 0.04, (2, 4, 2))
    labels[:, :4, 3:5] = rng.uniform(0.05, 0.6, (2, 4, 2))
    stride = (32, 16, 8)[level]
    hw = (SIZE // stride, SIZE // stride)
    anchors = ANCHORS[level] / stride
    want = jl._dense_targets(jnp.asarray(labels), jnp.asarray(anchors), hw,
                             ratio_thres=ratio_thres, neighbor_cells=neighbor_cells)
    got = tl._dense_targets(torch.from_numpy(labels), torch.from_numpy(anchors), hw,
                            ratio_thres=ratio_thres, neighbor_cells=neighbor_cells)
    assert float(got["pos"].sum()) > 0
    for key in ("pos", "box", "cls", "anchor", "gt_xywh_feat", "gt_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("neighbor_cells", [False, True])
def test_dense_targets_collisions_take_whole_rows(neighbor_cells):
    """Many GTs on one cell and anchor: each positive slot's box and class
    come from one GT (the JAX package's single concatenated scatter gives
    the same guarantee)."""
    rng = np.random.default_rng(3)
    b, m = 2, 12
    labels = np.zeros((b, m, 5), np.float32)
    labels[..., 0] = rng.integers(0, NUM_CLASSES, (b, m))
    labels[..., 1:3] = 0.5 + rng.uniform(-0.01, 0.01, (b, m, 2))  # one cell
    labels[..., 3:5] = 0.3 + rng.uniform(-0.02, 0.02, (b, m, 2))  # one anchor shape
    anchors = ANCHORS[0] / 32
    hw = (SIZE // 32, SIZE // 32)
    t = tl._dense_targets(torch.from_numpy(labels), torch.from_numpy(anchors), hw,
                          ratio_thres=4.0, neighbor_cells=neighbor_cells)
    pos = t["pos"].numpy() > 0
    assert pos.sum() > 0
    for bi, y, x, a in zip(*np.nonzero(pos)):
        wh, cls = t["box"][bi, y, x, a, 2:].numpy(), int(t["cls"][bi, y, x, a])
        twh = labels[bi, :, 3:5] * np.array([hw[1], hw[0]], np.float32)
        owners = np.nonzero((twh == wh).all(-1))[0]
        assert len(owners) == 1 and int(labels[bi, owners[0], 0]) == cls
        off = t["box"][bi, y, x, a, :2].numpy()
        txy = labels[bi, owners[0], 1:3] * np.array([hw[1], hw[0]], np.float32)
        np.testing.assert_array_equal(off, txy - np.array([x, y], np.float32))


def _jax_and_port_loss(heads, labels, **kw):
    jloss = jl.YOLOv3Loss(ANCHORS, num_classes=NUM_CLASSES, **kw)
    tloss = tl.YOLOv3Loss(ANCHORS, num_classes=NUM_CLASSES, **kw)
    # one compiled program: far quicker on the CPU than op-by-op dispatch
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda hs, lab: (jloss(hs, lab).total, jloss(hs, lab)), has_aux=True))(
        [jnp.asarray(h) for h in heads], jnp.asarray(labels))
    want = want[1]
    th = [torch.from_numpy(h).requires_grad_() for h in heads]
    got = tloss(th, torch.from_numpy(labels))
    got.total.backward()
    return want, want_grads, got, [h.grad for h in th]


@pytest.mark.parametrize("decode_style,neighbor_cells,label_case", [
    ("v5", False, "padded"), ("v5", True, "padded"), ("v3", False, "padded"),
    ("v3", True, "padded"), ("v5", True, "all_padding"), ("v3", False, "small_boxes"),
])
def test_yolov3_loss_and_grads_match_jax(decode_style, neighbor_cells, label_case):
    heads = _heads(4)
    if label_case == "padded":
        labels = _labels(5)
    elif label_case == "all_padding":
        labels = np.full((2, 8, 5), -1, np.float32)
    else:
        labels = _labels(6, n_real=8, lo=0.01, hi=0.1)
    want, want_grads, got, grads = _jax_and_port_loss(
        heads, labels, decode_style=decode_style, neighbor_cells=neighbor_cells,
        level_balance=(4.0, 1.0, 0.4))
    for name in ("total", "box", "obj", "cls"):
        np.testing.assert_allclose(float(getattr(got, name).detach()), float(getattr(want, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * w.std()


def test_ciou_backward_matches_jax():
    """CIoU's alpha is detached in both packages: the gradients agree."""
    from fastvision_tpu.ops.iou import box_iou as jax_box_iou

    rng = np.random.default_rng(7)
    b1 = np.concatenate([rng.uniform(0, 5, (64, 2)), rng.uniform(0.2, 3, (64, 2))], -1)
    b2 = np.concatenate([rng.uniform(0, 5, (64, 2)), rng.uniform(0.2, 3, (64, 2))], -1)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    want = jax.grad(lambda a, b: jax_box_iou(a, b, kind="ciou", fmt="xywh").sum(),
                    argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1, t2 = torch.from_numpy(b1).requires_grad_(), torch.from_numpy(b2).requires_grad_()
    box_iou(t1, t2, kind="ciou", fmt="xywh").sum().backward()
    for g, w in zip((t1.grad, t2.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_loss_takes_bf16_heads_in_float32():
    heads = [torch.from_numpy(h).to(torch.bfloat16) for h in _heads(8)]
    out = tl.YOLOv3Loss(ANCHORS, num_classes=NUM_CLASSES)(heads, torch.from_numpy(_labels(9)))
    assert out.total.dtype == torch.float32 and torch.isfinite(out.total)
    with pytest.raises(ValueError):
        tl.YOLOv3Loss(ANCHORS, decode_style="v4")
