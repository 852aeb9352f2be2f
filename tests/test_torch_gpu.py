"""Card-only tests of the PyTorch port: the CUDA NMS kernel against its plain
PyTorch version (also on Faster R-CNN's RPN and head inputs), the Detector's
and Faster R-CNN's kernel paths against their CPU paths, device-side mAP
matching, checkpoints of CUDA tensors, Detector.evaluate on the card, and
the classification path (a train step with the mix and the zoo's forwards
card vs CPU, process-pool loaders forked after CUDA initialised, the
classification evaluator).

Every test here is marked ``gpu`` and skips without a CUDA card. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py imports JAX.)

The kernel's cases cover K up to ``MAX_K`` (8192) and clustered inputs
(near-copies of a few objects, heavy suppression, as trained weights give).

Tolerance: keep masks and Detections bit-equal. The kernel rounds every
float32 intermediate as the plain version does (no FMA contraction, IEEE
division), and everything around it is the same PyTorch code on both sides.
"""
import numpy as np
import pytest
import torch

from fastvision_tpu_torch.infer import Detector
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.ops import COCO_ANCHORS, batched_non_max_suppression, nms_candidates
from fastvision_tpu_torch.ops.nms import suppression_mask
from fastvision_tpu_torch.ops.nms_kernel import (
    MAX_K,
    suppression_mask_cuda,
    suppression_mask_plain,
)
from fastvision_tpu_torch.testing import nms_case, rpn_nms_case

torch.set_num_threads(2)
pytestmark = pytest.mark.gpu


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("iou_thres", [0.45, 0.6])
@pytest.mark.parametrize("b,k", [(1, 1), (1, 37), (8, 64), (8, 1024), (256, 1024), (3, MAX_K),
                                 (2, 2049), (2, 4096), (1, 8192), (4, 1000)])
@pytest.mark.parametrize("flags", [
    dict(), dict(ties=False, neg_inf_tail=False, on_threshold=False),
    dict(class_offset=None), dict(clusters=20),
], ids=["stress", "random", "no_offset", "clustered"])
def test_kernel_mask_equals_plain(b, k, iou_thres, flags):
    dev = _cuda()
    boxes, scores = nms_case(b * 7919 + k, b, k, iou_thres, **flags)
    boxes, scores = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    before = suppression_mask_cuda.launches
    got = suppression_mask_cuda(boxes, scores, iou_thres)
    torch.cuda.synchronize()
    assert suppression_mask_cuda.launches == before + 1
    want = suppression_mask_plain(boxes, scores, iou_thres)
    assert got.dtype == torch.bool and got.shape == (b, k)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("iou_thres", [0.15, 0.25, 0.35, 0.65])
@pytest.mark.parametrize("flags", [dict(), dict(clusters=20)], ids=["stress", "clustered"])
def test_kernel_mask_equals_plain_at_sweep_thresholds(iou_thres, flags):
    """Detector.evaluate's batch (32) and candidates (1024) at the reference
    sweep's IoU thresholds: low ones suppress far more than 0.45."""
    dev = _cuda()
    boxes, scores = nms_case(32 * 7919 + int(100 * iou_thres), 32, 1024, iou_thres, **flags)
    boxes, scores = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    got = suppression_mask_cuda(boxes, scores, iou_thres)
    want = suppression_mask_plain(boxes, scores, iou_thres)
    assert torch.equal(got, want), int((got != want).sum())


def test_kernel_wrapper_rejects_what_it_does_not_take():
    dev = _cuda()
    boxes, scores = (torch.from_numpy(a).to(dev) for a in nms_case(0, 2, 64))
    with pytest.raises(TypeError):
        suppression_mask_cuda(boxes.double(), scores, 0.45)
    with pytest.raises(ValueError, match="contiguous"):
        suppression_mask_cuda(boxes.transpose(0, 1).contiguous().transpose(0, 1), scores, 0.45)
    with pytest.raises(ValueError):
        suppression_mask_cuda(boxes[..., :3].contiguous(), scores, 0.45)
    with pytest.raises(ValueError, match="K <="):
        suppression_mask_cuda(torch.zeros(1, MAX_K + 1, 4, device=dev),
                              torch.zeros(1, MAX_K + 1, device=dev), 0.45)
    # boxes at an offset that is not a multiple of 16 bytes
    odd = torch.empty(boxes.numel() + 1, device=dev)[1:].view_as(boxes).copy_(boxes)
    with pytest.raises(ValueError, match="aligned"):
        suppression_mask_cuda(odd, scores, 0.45)
    # the dispatcher makes its inputs contiguous and aligned, and takes single images
    keep = suppression_mask(boxes[0], scores[0], 0.45)
    assert torch.equal(keep, suppression_mask_plain(boxes, scores, 0.45)[0])
    assert torch.equal(suppression_mask(odd, scores, 0.45),
                       suppression_mask_plain(boxes, scores, 0.45))


def test_detector_kernel_path_equals_cpu_path():
    """A shallow model at 96 px: the predictions decoded on the card go
    through NMS on the card (kernel) and on the CPU (plain version)."""
    dev = _cuda()
    g = torch.Generator().manual_seed(5)
    model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1), generator=g)
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    det = Detector(model, anchors, input_size=96, batch_size=4, device=dev)
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
            for hw in ((96, 96), (120, 80), (50, 96), (200, 300))]
    before = suppression_mask_cuda.launches
    out = det.predict_batch(imgs)
    assert suppression_mask_cuda.launches == before + 1
    for r, im in zip(out, imgs):
        h, w = im.shape[:2]
        assert np.isfinite(r["boxes"]).all() and (r["boxes"] >= 0).all()
        assert (r["boxes"][:, [0, 2]] <= w).all() and (r["boxes"][:, [1, 3]] <= h).all()

    batch = torch.from_numpy(np.stack([np.full((96, 96, 3), v, np.uint8) for v in (0, 60, 114, 255)]))
    pred = det.predecode(batch.to(dev)).float()
    kw = dict(conf_thres=0.05, iou_thres=0.45, max_det=300, class_offset=det.class_offset)
    on_card = batched_non_max_suppression(pred, **kw)
    on_cpu = batched_non_max_suppression(pred.cpu(), **kw)
    assert int(on_card.valid.sum()) > 0
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    # and the kernel's own input, as batched_non_max_suppression builds it
    _, nms_boxes, scores, _ = nms_candidates(pred, conf_thres=0.05, pre_nms_top_k=256,
                                             class_offset=det.class_offset)
    before = suppression_mask_cuda.launches
    keep = suppression_mask(nms_boxes, scores, 0.45)  # a K-slice view: made contiguous
    assert suppression_mask_cuda.launches == before + 1
    assert torch.equal(keep.cpu(), suppression_mask_plain(nms_boxes.cpu(), scores.cpu(), 0.45))


def _train_parts(num_classes=80):
    from fastvision_tpu_torch.train import YOLOv3Loss

    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    loss = YOLOv3Loss(anchors, num_classes=num_classes)

    def loss_fn(heads, batch):
        out = loss(heads, batch["labels"])
        return out.total, {"box": out.box, "obj": out.obj, "cls": out.cls}

    return anchors, loss_fn


def _one_batch(size=128, n=4, seed=3):
    from fastvision_tpu_torch.data import DetectionLoader
    from fastvision_tpu_torch.testing import SyntheticDetectionDataset

    ds = SyntheticDetectionDataset(n, 80, seed=seed)
    return next(iter(DetectionLoader(ds, size, n, max_boxes=8, seed=seed)))


def test_train_step_on_card_equals_cpu():
    """One float32 SGD step (TF32 off) of a shallow YOLOv3 on the card and
    on the CPU from the same weights and batch. Tolerances: loss 1e-4
    relative; kernels max|d| <= 1e-3 * std; the other tensors (BN scale
    and shift, biases, running statistics) max|d| <= 1e-2 of max(std,
    largest update). Train-mode BN over few values per channel amplifies
    float32 rounding in the backward (~5e-5 of the largest gradient between
    the CPU and a float64 run), and cuDNN's float32 algorithms round
    otherwise than the CPU's: a BN scale's one-step update differed by
    2.4e-3 of itself (H100, 256 px)."""
    import copy

    from fastvision_tpu_torch.testing import state_max_rel_diff
    from fastvision_tpu_torch.train import TrainState, build_optimizer, make_train_step

    dev = _cuda()
    _, loss_fn = _train_parts()
    model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(7))
    cpu_model = copy.deepcopy(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _one_batch()
    step = make_train_step(loss_fn)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = TrainState.create(model, build_optimizer("sgd", model), dev)
        on_cpu = TrainState.create(cpu_model, build_optimizer("sgd", cpu_model), "cpu")
        _, m_dev = step(on_card, {k: torch.from_numpy(batch[k]).to(dev)
                                  for k in ("images", "labels")}, 1e-2)
        _, m_cpu = step(on_cpu, {k: torch.from_numpy(batch[k]) for k in ("images", "labels")},
                        1e-2)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert float(m_dev["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-4)
    assert float(m_dev["grad_norm"]) == pytest.approx(float(m_cpu["grad_norm"]), rel=1e-3)
    worst = state_max_rel_diff(model.state_dict(), cpu_model.state_dict(), start)
    assert worst["kernels"][0] <= 1e-3 and worst["others"][0] <= 1e-2, worst


def test_fit_on_card_validates_through_the_nms_kernel():
    """bf16 Fit of 2 steps with EMA, then validation: one NMS kernel launch
    per validation batch, finite loss, map in [0, 1]."""
    from fastvision_tpu_torch.data import DetectionLoader
    from fastvision_tpu_torch.infer import decode_predictions
    from fastvision_tpu_torch.testing import SyntheticDetectionDataset
    from fastvision_tpu_torch.train import (
        Fit,
        build_optimizer,
        detection_evaluator,
        make_eval_step,
        warmup_cosine_lr,
    )

    _cuda()
    anchors, loss_fn = _train_parts()
    anchors_t = torch.from_numpy(anchors).cuda()
    model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(8))

    def post(heads, batch):
        return batched_non_max_suppression(decode_predictions(heads, anchors_t).float(),
                                           conf_thres=0.01, max_det=100)

    records = []

    class Log:
        def log(self, step, **kw):
            records.append(kw)

    train = DetectionLoader(SyntheticDetectionDataset(8, 80, seed=1), 128, 4, max_boxes=8)
    val = DetectionLoader(SyntheticDetectionDataset(6, 80, seed=2), 128, 4, train=False)
    fit = Fit(model, loss_fn, build_optimizer("sgd", model), train, val, epochs=1,
              schedule=warmup_cosine_lr(1e-2, 1e-4, 2, 1), ema_decay=0.9999,
              evaluator=detection_evaluator(make_eval_step(post, dtype=torch.bfloat16)),
              dtype=torch.bfloat16, logger=Log())
    assert fit.device.type == "cuda"
    before = suppression_mask_cuda.launches
    fit.run()
    assert suppression_mask_cuda.launches == before + 2  # 6 images at batch 4
    assert fit.global_step == 2
    last = records[-1]
    assert np.isfinite(last["train_loss"]) and 0.0 <= last["map50"] <= 1.0


def test_prefetch_to_device_copies_to_the_card():
    from fastvision_tpu_torch.data import prefetch_to_device

    _cuda()
    host = [{"images": np.full((2, 8, 8, 3), i, np.uint8),
             "labels": np.full((2, 3, 5), -1.0, np.float32), "num_real": 2} for i in range(5)]
    got = list(prefetch_to_device(iter(host)))
    assert len(got) == 5
    for g, h in zip(got, host):
        assert g["images"].device.type == "cuda" and g["num_real"] == 2
        assert torch.equal(g["images"].cpu(), torch.from_numpy(h["images"]))
        assert torch.equal(g["labels"].cpu(), torch.from_numpy(h["labels"]))


def test_bn_train_mode_under_bf16_autocast_keeps_float32_statistics():
    from fastvision_tpu_torch.nn import ConvBN

    dev = _cuda()
    x = torch.randn(4, 8, 13, 13, generator=torch.Generator().manual_seed(0))
    ref = ConvBN(8, 16, 3).train()
    card = ConvBN(8, 16, 3).train()
    card.load_state_dict(ref.state_dict())
    card.to(dev, memory_format=torch.channels_last)
    ref(x)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = card(x.to(dev))
    assert y.dtype == torch.bfloat16
    assert card.bn.running_var.dtype == torch.float32
    torch.testing.assert_close(card.bn.running_var.cpu(), ref.bn.running_var, rtol=2e-2, atol=1e-3)
    torch.testing.assert_close(card.bn.running_mean.cpu(), ref.bn.running_mean,
                               rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("case", ["rpn_eval", "rpn_train", "head"])
def test_kernel_mask_equals_plain_on_frcnn_inputs(case):
    """Faster R-CNN's two regimes: the RPN's dense class-agnostic boxes at
    IoU 0.7 (K = 1000 at eval, 2000 in training) and the head's
    class-offset boxes (20 classes) at IoU 0.3, K = 400."""
    dev = _cuda()
    if case == "head":
        thr = 0.3
        boxes, scores = nms_case(41, 8, 400, thr, num_classes=20, clusters=30,
                                 ties=False, on_threshold=False)
    else:
        thr = 0.7
        boxes, scores = rpn_nms_case(40, 8, 1000 if case == "rpn_eval" else 2000)
    boxes, scores = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    got = suppression_mask_cuda(boxes, scores, thr)
    want = suppression_mask_plain(boxes, scores, thr)
    assert 0 < int(want.sum()) < want.numel()
    assert torch.equal(got, want), int((got != want).sum())


def _frcnn(seed=9, **kw):
    from fastvision_tpu_torch.models import FasterRCNN

    cfg = dict(num_classes=3, image_size=128, anchor_scales=(2, 4, 6), rpn_pre_nms_train=256,
               rpn_post_nms_train=64, rpn_pre_nms_eval=256, rpn_post_nms_eval=64,
               roi_pos=4, roi_neg=12)
    return FasterRCNN(**{**cfg, **kw}, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("form", ["roi_align", "roi_align_mxu"])
def test_roi_align_on_card_equals_cpu(form):
    import fastvision_tpu_torch.ops as ops

    dev = _cuda()
    rng = np.random.default_rng(10)
    feat = torch.from_numpy(rng.normal(size=(2, 32, 32, 64)).astype(np.float32))
    xy = rng.uniform(-20, 400, (2, 50, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(1, 300, (2, 50, 2))],
                                            -1).astype(np.float32))
    fn = getattr(ops, form)
    flags = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = fn(feat.to(dev), boxes.to(dev)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags
    want = fn(feat, boxes)
    # the card contracts y1 + off * bin into one FMA: sample coordinates
    # (up to ~30 feature cells) differ by an ulp, weights by ~2e-6
    assert float((got - want).abs().max()) <= 1e-4 * float(want.std())


def test_frcnn_eval_step_on_card():
    """The eval step on the card launches the kernel twice (RPN, head); its
    float32 outputs match the CPU's (TF32 off), and selection from the
    card's own NMS inputs is identical on the card and on the CPU."""
    import copy

    from fastvision_tpu_torch.models.detection import (
        detection_candidates,
        proposal_candidates,
        select_detections,
        select_proposals,
    )
    from fastvision_tpu_torch.train import TrainState, make_frcnn_eval_step

    dev = _cuda()
    model = _frcnn()
    cpu_model = copy.deepcopy(model).eval()
    state = TrainState.create(model, None, dev)
    images = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (2, 128, 128, 3),
                                                                 dtype=np.uint8))
    before = suppression_mask_cuda.launches
    det = make_frcnn_eval_step(score_thresh=0.0, dtype=torch.bfloat16)(
        state, {"images": images.to(dev)})
    torch.cuda.synchronize()
    assert suppression_mask_cuda.launches == before + 2
    assert det.boxes.shape == (2, 100, 4) and int(det.valid.sum()) > 0
    assert bool(torch.isfinite(det.boxes).all())

    from fastvision_tpu_torch.data import normalize_images

    x = normalize_images(images, imagenet=True)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model.eval()
        with torch.inference_mode():
            feat = model.features(x.to(dev))
            anchors, obj, deltas, proposals, valid = model.propose(feat)
            cls_logits, boxes = model.detect(feat, proposals)
            feat_c = cpu_model.features(x)
            _, obj_c, deltas_c, _, _ = cpu_model.propose(feat_c)
            cls_c, boxes_c = cpu_model.detect(feat_c, proposals.cpu())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for got, want in ((obj, obj_c), (deltas, deltas_c), (cls_logits, cls_c), (boxes, boxes_c)):
        assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(want.std())
    top_b, top_s = proposal_candidates(anchors, obj, deltas, 128, 256)
    on_card = select_proposals(top_b, top_s, 0.7, 64)
    on_cpu = select_proposals(top_b.cpu(), top_s.cpu(), 0.7, 64)
    assert torch.equal(on_card[0].cpu(), on_cpu[0]) and torch.equal(on_card[2].cpu(), on_cpu[2])
    # sigmoid differs by an ulp between the card's and the CPU's implementations
    torch.testing.assert_close(on_card[1].cpu(), on_cpu[1], rtol=1e-6, atol=0.0)
    cands = detection_candidates(cls_logits, boxes, valid, 0.0, 100)
    for a, b in zip(select_detections(*cands, 0.3, 100),
                    select_detections(*(t.cpu() for t in cands), 0.3, 100)):
        assert torch.equal(a.cpu(), b)


def test_frcnn_train_step_on_card_equals_cpu():
    """One float32 SGD step (TF32 off) on the card and on the CPU from the
    same weights, batch and draws: losses within 1e-4 relative, weights
    within 1e-3 of their std or 1e-2 of their largest update."""
    import copy

    from fastvision_tpu_torch.data import DetectionLoader
    from fastvision_tpu_torch.models.detection import make_draws
    from fastvision_tpu_torch.testing import SyntheticDetectionDataset, state_max_rel_diff
    from fastvision_tpu_torch.train import TrainState, build_optimizer, make_frcnn_train_step

    dev = _cuda()
    model = _frcnn(12)
    cpu_model = copy.deepcopy(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch = next(iter(DetectionLoader(SyntheticDetectionDataset(2, 3, seed=4), 128, 2,
                                      max_boxes=6, seed=4)))
    draws = make_draws(torch.Generator().manual_seed(13), 2, 8 * 8 * 9, 64, 16, 4096, 0.5)
    step = make_frcnn_train_step(seed=0)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = TrainState.create(model, build_optimizer("sgd", model, grad_clip_norm=10.0), dev)
        on_cpu = TrainState.create(cpu_model, build_optimizer("sgd", cpu_model,
                                                              grad_clip_norm=10.0), "cpu")
        before = suppression_mask_cuda.launches
        _, m_dev = step(on_card, {k: torch.from_numpy(batch[k]).to(dev)
                                  for k in ("images", "labels")}, 1e-3,
                        draws=type(draws)(*(t.to(dev) for t in draws)))
        torch.cuda.synchronize()
        assert suppression_mask_cuda.launches == before + 1
        _, m_cpu = step(on_cpu, {k: torch.from_numpy(batch[k]) for k in ("images", "labels")},
                        1e-3, draws=draws)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for k in ("rpn_cls", "rpn_reg", "cls", "reg", "loss"):
        assert float(m_dev[k]) == pytest.approx(float(m_cpu[k]), rel=1e-4), k
    worst = state_max_rel_diff(model.state_dict(), cpu_model.state_dict(), start)
    assert worst["kernels"][0] <= 1e-3 and worst["others"][0] <= 1e-2, worst


def test_match_predictions_device_on_card_equals_cpu():
    from fastvision_tpu_torch.ops import match_predictions_device

    dev = _cuda()
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 80, (16, 12, 2)).astype(np.float32)
    gt = np.concatenate([gt, gt + rng.uniform(4, 40, (16, 12, 2)).astype(np.float32)], -1)
    src = rng.integers(0, 12, (16, 300))
    pred = np.take_along_axis(gt, src[..., None], 1) + rng.normal(0, 3, (16, 300, 4))
    args = [torch.from_numpy(pred.astype(np.float32)), torch.from_numpy(src % 3).float(),
            torch.from_numpy(rng.uniform(size=(16, 300)) < 0.8),
            torch.from_numpy(gt), torch.from_numpy(rng.integers(0, 3, (16, 12))).float(),
            torch.from_numpy(rng.uniform(size=(16, 12)) < 0.9)]
    thr = torch.linspace(0.5, 0.95, 10)
    want = match_predictions_device(*args, thr)
    got = match_predictions_device(*(a.to(dev) for a in args), thr.to(dev))
    assert want.any() and torch.equal(got.cpu(), want)


def test_checkpoint_save_restore_on_card(tmp_path):
    """CUDA tensors go through pinned host buffers: the restored state is
    the saved one bit for bit, and the live tensors may change at once."""
    from fastvision_tpu_torch.core import CheckpointManager

    dev = _cuda()
    model = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(0)).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        sum(h.float().sum() for h in model(torch.rand(2, 64, 64, 3, device=dev))).backward()
    opt.step()
    want = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, model.state_dict(), opt.state_dict())
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    mgr.wait()
    got = mgr.restore()["state"]
    assert all(torch.equal(got["model"][k], v) for k, v in want.items())
    momentum = [s["momentum_buffer"] for s in got["optimizer"]["state"].values()]
    assert len(momentum) == len(list(model.parameters())) and momentum[0].device.type == "cpu"
    model.load_state_dict(got["model"])
    assert all(torch.equal(v.cpu(), want[k]) for k, v in model.state_dict().items())


def test_evaluate_on_card_device_equals_host_matching(tmp_path):
    """Detector.evaluate on the card: device matching equals the host's
    boxes scored with the device's rule; the sweep's rows equal per-point
    host-matched evaluate; the kernel launches on each path."""
    from fastvision_tpu_torch.infer import Detector as Det
    from fastvision_tpu_torch.testing import SyntheticDetectionDataset

    dev = _cuda()
    model = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(0))
    anchors = (np.array([[[32, 32], [40, 24], [24, 40]]] * 3, np.float32)
               / np.array([1, 1.6, 2.5], np.float32)[:, None, None])
    ds = SyntheticDetectionDataset(6, 3, seed=1, sizes=((64, 64), (48, 80)))
    cpu = Det(model, anchors, input_size=64, batch_size=4, conf_thres=0.05, device="cpu",
              dtype=torch.float32).evaluate(ds, device_matching=True)
    det = Det(model, anchors, input_size=64, batch_size=4, conf_thres=0.05, device=dev,
              dtype=torch.float32)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = suppression_mask_cuda.launches
        on_dev = det.evaluate(ds, device_matching=True)
        assert suppression_mask_cuda.launches == before + 2
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert abs(on_dev["map"] - cpu["map"]) <= 1e-4 and abs(on_dev["map50"] - cpu["map50"]) <= 1e-4
    points = [(0.05, 0.45), (0.3, 0.25)]
    rows = det.evaluate_sweep(ds, points)
    for (conf, iou), row in zip(points, rows):
        ref = Det(model, anchors, input_size=64, batch_size=4, conf_thres=conf, iou_thres=iou,
                  device=dev, dtype=torch.float32).evaluate(ds, device_matching=False)
        assert (row["map50"], row["map"]) == (ref["map50"], ref["map"])


# ---------------------------------------------------------------- classification
def _small_resnext(seed=0):
    from fastvision_tpu_torch.models.classification import Bottleneck, ResNet

    return ResNet(Bottleneck, (1, 1, 1, 1), num_classes=10, groups=4, base_width=4,
                  generator=torch.Generator().manual_seed(seed))


def test_cls_train_step_with_mix_on_card_equals_cpu():
    """One SGD step of a small ResNeXt with mixup + cutmix + smoothing, the
    card against the CPU, in float64 (a float32 ReLU net with train-mode BN
    sits up to 1e-2 from float64 at random batches, on either device). The
    mix's draws come from the host's generator, so both see the same ones.
    Tolerances: loss 1e-4 relative, kernels 1e-3 of std, the rest 1e-2."""
    import copy

    from fastvision_tpu_torch.testing import state_max_rel_diff
    from fastvision_tpu_torch.train import (
        TrainState,
        build_optimizer,
        make_classification_mix,
        make_train_step,
        soft_cross_entropy,
    )

    dev = _cuda()
    model = _small_resnext().double()
    cpu_model = copy.deepcopy(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(3)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 10, 8))}
    step = make_train_step(lambda lg, b: (soft_cross_entropy(lg, b["soft"]), {}),
                           torch.float64, imagenet=True, transform_seed=5,
                           batch_transform=make_classification_mix(10, 0.2, 1.0, 0.1))
    on_card = TrainState.create(model, build_optimizer("sgd", model), dev)
    on_cpu = TrainState.create(cpu_model, build_optimizer("sgd", cpu_model), "cpu")
    _, m_dev = step(on_card, {k: v.to(dev) for k, v in batch.items()}, 1e-2)
    _, m_cpu = step(on_cpu, batch, 1e-2)
    assert float(m_dev["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-4)
    worst = state_max_rel_diff(model.state_dict(), cpu_model.state_dict(), start)
    assert worst["kernels"][0] <= 1e-3 and worst["others"][0] <= 1e-2, worst


@pytest.mark.parametrize("name", ["resnext", "vgg", "darknet53", "vit"])
def test_cls_zoo_forward_on_card_equals_cpu(name):
    """float32 eval forwards (TF32 off), card vs CPU: max|d| <= 1e-3 * std."""
    from fastvision_tpu_torch.models import classification as tz

    dev = _cuda()
    g = torch.Generator().manual_seed(1)
    model = {"resnext": lambda: _small_resnext(1),
             "vgg": lambda: tz.VGG((8, "M", 16, "M"), num_classes=10, generator=g),
             "darknet53": lambda: tz.Darknet53(stage_sizes=(1, 1, 1, 1, 1), including_top=True,
                                               num_classes=10, generator=g),
             "vit": lambda: tz.ViT(num_classes=10, patch=8, dim=64, depth=2, heads=4,
                                   image_size=32, generator=g)}[name]().eval()
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = model(x)
            got = model.to(dev)(x.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert float((got - want).abs().max() / want.std()) <= 1e-3


def test_cls_loader_process_pool_after_cuda_init_and_evaluator_on_card(tmp_path):
    """Workers forked from a process that holds a CUDA context (they never
    touch it) give the serial loader's bytes; classification_evaluator runs
    on the card and counts the real images of a padded last batch."""
    from fastvision_tpu_torch.data import ClassificationDataset, ClassificationLoader
    from fastvision_tpu_torch.testing import write_classification_dataset
    from fastvision_tpu_torch.train import TrainState, classification_evaluator, make_eval_step

    dev = _cuda()
    torch.zeros(1, device=dev)
    root = write_classification_dataset(str(tmp_path), 11, num_classes=3,
                                        sizes=((240, 320), (64, 64)), seed=4)
    ds = ClassificationDataset(root, "val")
    serial = list(ClassificationLoader(ds, 64, 4, train=False).epoch(0))
    pooled_loader = ClassificationLoader(ds, 64, 4, train=False, num_workers=3,
                                         worker_backend="process")
    try:
        pooled = list(pooled_loader.epoch(0))
        assert len(pooled) == len(serial) == 3
        for a, b in zip(pooled, serial):
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
        model = _small_resnext(2)
        state = TrainState.create(model, None, dev)
        res = classification_evaluator(make_eval_step(imagenet=True))(state, pooled_loader)
    finally:
        pooled_loader.close()
    step = make_eval_step(imagenet=True)
    pred = np.concatenate([step(state, {"images": torch.from_numpy(b["images"]).to(dev)})
                           .argmax(-1).cpu().numpy()[:b["num_real"]] for b in serial])
    labels = np.concatenate([b["labels"][:b["num_real"]] for b in serial])
    assert len(labels) == 11 and res["accuracy"] == pytest.approx(float((pred == labels).mean()))


# ---------------------------------------------------------------- video
def _small_slowfast(seed=0):
    from fastvision_tpu_torch.models.video import SlowFast

    return SlowFast((1, 1, 1, 1), num_classes=5, alpha=4, beta_inv=4, expansion=1,
                    generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", ["c3d_bn", "resnet18_3d", "slowfast"])
def test_video_zoo_forward_on_card_equals_cpu(name):
    """float32 eval forwards (TF32 off) in channels_last_3d, card vs CPU:
    max|d| <= 1e-3 * std; C3D at 16 x 32 (the adaptive pool upsamples)."""
    from fastvision_tpu_torch.models import video as tv

    dev = _cuda()
    g = torch.Generator().manual_seed(1)
    model, t = {"c3d_bn": lambda: (tv.c3d_bn(num_classes=5, generator=g), 16),
                "resnet18_3d": lambda: (tv.resnet18_3d(num_classes=5, generator=g), 8),
                "slowfast": lambda: (_small_slowfast(1), 8)}[name]()
    model.eval()
    x = torch.rand(2, t, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = model(x)
            got = model.to(dev, memory_format=torch.channels_last_3d)(x.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert float((got - want).abs().max() / want.std()) <= 1e-3


def test_video_train_step_on_card_equals_cpu():
    """One SGD step of a small SlowFast in float64, card vs CPU, after
    ``TrainState.create`` placed it in channels_last_3d. Tolerances: loss
    1e-4 relative, kernels 1e-3 of std, the rest 1e-2."""
    import copy

    from fastvision_tpu_torch.testing import state_max_rel_diff
    from fastvision_tpu_torch.train import (
        TrainState,
        build_optimizer,
        cross_entropy,
        make_train_step,
    )

    dev = _cuda()
    model = _small_slowfast().double()
    cpu_model = copy.deepcopy(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(4)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (4, 8, 32, 32, 3), dtype=np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 5, 4))}
    step = make_train_step(lambda lg, b: (cross_entropy(lg, b["labels"]), {}), torch.float64,
                           imagenet=True)
    on_card = TrainState.create(model, build_optimizer("sgd", model, momentum=0.9), dev)
    assert model.fast_pathway.conv1[0].weight.is_contiguous(memory_format=torch.channels_last_3d)
    on_cpu = TrainState.create(cpu_model, build_optimizer("sgd", cpu_model, momentum=0.9), "cpu")
    _, m_dev = step(on_card, {k: v.to(dev) for k, v in batch.items()}, 1e-2)
    _, m_cpu = step(on_cpu, batch, 1e-2)
    assert float(m_dev["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-4)
    worst = state_max_rel_diff(model.state_dict(), cpu_model.state_dict(), start)
    assert worst["kernels"][0] <= 1e-3 and worst["others"][0] <= 1e-2, worst


def test_video_loader_process_pool_after_cuda_init_and_multiclip_evaluator_on_card(tmp_path):
    """A VideoClipLoader's workers forked from a process that holds a CUDA
    context give the serial loader's bytes; the multi-clip evaluator runs
    on the card with the clips read on that pool, and its accuracy is the
    one of the per-clip logits summed by hand."""
    from fastvision_tpu_torch.data import VideoClipLoader, VideoFolderDataset
    from fastvision_tpu_torch.testing import write_video_dataset
    from fastvision_tpu_torch.train import (
        TrainState,
        make_eval_step,
        multiclip_windows,
        video_multiclip_evaluator,
    )

    dev = _cuda()
    torch.zeros(1, device=dev)
    root = write_video_dataset(str(tmp_path), 5, num_classes=5, frames=12, hw=(40, 48), seed=4,
                               splits=("val",))
    ds = VideoFolderDataset(root, "val")
    serial = list(VideoClipLoader(ds, 8, 32, 2, train=False).epoch(0))
    pooled_loader = VideoClipLoader(ds, 8, 32, 2, train=False, num_workers=3,
                                    worker_backend="process")
    state = TrainState.create(_small_slowfast(2), None, dev)
    step = make_eval_step(imagenet=True)
    try:
        pooled = list(pooled_loader.epoch(0))
        assert len(pooled) == len(serial) == 3
        for a, b in zip(pooled, serial):
            np.testing.assert_array_equal(a["images"], b["images"])
        res = video_multiclip_evaluator(step, n_clips=3)(state, pooled_loader)
    finally:
        pooled_loader.close()
    sums = []
    for v in range(len(ds)):
        clips = np.stack([ds.load_clip(v, 8, "consecutive", 32, None, indices=w)[0]
                          for w in multiclip_windows(ds.clip_length(v), 8, 3)])
        sums.append(step(state, {"images": torch.from_numpy(clips).to(dev)}).float().sum(0))
    pred = torch.stack(sums).argmax(-1).cpu().numpy()
    labels = np.array([lab for _, lab in ds.samples])
    assert res == {"accuracy": pytest.approx(float((pred == labels).mean())), "n_clips": 3}
