"""Card-only tests of the PyTorch port: the CUDA NMS kernel against its plain
PyTorch version (also on Faster R-CNN's RPN and head inputs), the Detector's
and Faster R-CNN's kernel paths against their CPU paths, device-side mAP
matching, checkpoints of CUDA tensors, Detector.evaluate on the card, and
the classification path (a train step with the mix and the zoo's forwards
card vs CPU, process-pool loaders forked after CUDA initialised, the
classification evaluator), and int8 inference (the int8 conv's card route,
int8 patches + ``torch._int_mm``, bit-equal to its plain version on
`testing.INT8_CONV_CASES`; the implicit-GEMM kernel ``csrc/int8_conv.cu``
bit-equal to the plain version and byte-equal to that route on
`testing.INT8_IMPLICIT_CASES`, its fused epilogue (residual add, the
consumer's int8 input) byte-equal to the composed route; the patches line
kernel on the stems; a quantized Detector on the card against the CPU,
linked and unlinked, with no float conv on a quantized layer), and data
parallelism (the global BN on the card against the CPU; a step under DDP
and FSDP in a one-rank NCCL group against the plain step), and the image
and video reads of the cv2-parity fixtures against their manifests and this
machine's cv2.

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
import copy
import os

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
from fastvision_tpu_torch.testing import (
    INT8_CONV_CASES,
    INT8_IMPLICIT_CASES,
    int8_conv_case,
    nms_case,
    rpn_nms_case,
)

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


def test_multisteps_follows_a_model_moved_to_the_card():
    """`build_optimizer(accum_steps=2)` over a model still on the CPU, then
    `TrainState.create` moves it: the means follow the parameters to the
    card, and 4 calls match the same calls on the CPU; a state dict saved
    mid-cycle on the card loads into a CPU optimizer."""
    from fastvision_tpu_torch.train import TrainState, build_optimizer, set_lr

    dev = _cuda()
    gen = torch.Generator().manual_seed(0)
    card_model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Conv2d(4, 2, 1))
    cpu_model = copy.deepcopy(card_model)
    card = TrainState.create(card_model, build_optimizer("adam", card_model, accum_steps=2,
                                                         grad_clip_norm=1.0), dev)
    cpu = TrainState.create(cpu_model, build_optimizer("adam", cpu_model, accum_steps=2,
                                                       grad_clip_norm=1.0), "cpu")
    for call in range(4):
        grads = [torch.randn(p.shape, generator=gen) for p in cpu_model.parameters()]
        for state in (card, cpu):
            for p, g in zip(state.model.parameters(), grads):
                p.grad = g.to(p.device)
            set_lr(state.optimizer, 1e-2)
            state.optimizer.step()
        if call == 2:
            saved = card.optimizer.state_dict()
    for a, b in zip(card_model.parameters(), cpu_model.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-6, atol=1e-7)
    other = build_optimizer("adam", copy.deepcopy(cpu_model), accum_steps=2, grad_clip_norm=1.0)
    other.load_state_dict(saved)
    assert other.mini_step == 1 and all(a.device.type == "cpu" for a in other.acc)


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


def _serving_predictions(seed, b, n=10647, c=80, size=416):
    """Decoded-prediction-like rows [B, N, 5 + C] at the serving preset's
    shapes (YOLOv3-416: 10,647 boxes x 80 classes): xywh in pixels, some
    boxes under min_wh, sigmoid-range objectness and class scores."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size, (b, n, 2))
    wh = rng.uniform(1.0, size / 2, (b, n, 2))
    obj = rng.beta(0.5, 4.0, (b, n, 1))
    cls = rng.beta(0.5, 6.0, (b, n, c))
    return torch.from_numpy(np.concatenate([xy, wh, obj, cls], -1).astype(np.float32))


@pytest.mark.parametrize("b", [1, 4, 8])
def test_kernel_mask_equals_plain_on_multilabel_inputs(b):
    """The serving preset's regime: every (box, class) pair a candidate at
    conf 0.001, K = 1024 slots all full, one box under several class
    offsets, IoU 0.6; and the whole multi-label NMS on the card equals the
    CPU's."""
    from fastvision_tpu_torch.ops import multilabel_candidates, non_max_suppression_multilabel
    from fastvision_tpu_torch.ops.nms import class_offset_for

    dev = _cuda()
    pred = _serving_predictions(b, b)
    offset = class_offset_for(3.0 * 416)
    _, nms_boxes, scores, _ = multilabel_candidates(pred.to(dev), 0.001, class_offset=offset)
    nms_boxes, scores = nms_boxes.contiguous(), scores.contiguous()
    assert bool((scores > float("-inf")).all())
    before = suppression_mask_cuda.launches
    got = suppression_mask_cuda(nms_boxes, scores, 0.6)
    torch.cuda.synchronize()
    assert suppression_mask_cuda.launches == before + 1
    assert torch.equal(got, suppression_mask_plain(nms_boxes, scores, 0.6))
    kw = dict(conf_thres=0.001, iou_thres=0.6, class_offset=offset)
    on_card = non_max_suppression_multilabel(pred.to(dev), **kw)
    on_cpu = non_max_suppression_multilabel(pred, **kw)
    for x, y in zip(on_card, on_cpu):
        assert torch.equal(x.cpu(), y)


def test_vision_service_round_trip_on_card():
    """VisionService with the serving preset's NMS on the card behind
    make_server: warmup builds the decoder and the kernel and runs every
    bucket; /predict decodes a JPEG of the corpus without cv2 and answers as
    VisionService.predict does, through the kernel; the Detections of the
    card's predictions equal the CPU's (plain version) on the same tensor."""
    import http.client
    import json
    import socket
    import threading

    from fastvision_tpu_torch.infer import VisionService, make_server, preprocess_batch
    from fastvision_tpu_torch.data.codec import decode_image

    dev = _cuda()
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(6))
    card = VisionService(Detector(model, anchors, input_size=128, batch_size=4,
                                  batch_buckets=(1, 2), conf_thres=0.001, iou_thres=0.6,
                                  multi_label=True, device=dev))
    card.warmup()
    assert card.warmed_buckets == [1, 2, 4]
    with open(os.path.join(os.path.dirname(__file__), "torch_codec_fixtures",
                           "full_480x640.jpg"), "rb") as f:
        body = f.read()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = make_server(card, "127.0.0.1", port)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        before = suppression_mask_cuda.launches
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/predict", body=body)
        r = c.getresponse()
        got = json.loads(r.read())
        c.close()
        assert r.status == 200 and suppression_mask_cuda.launches == before + 1
    finally:
        server.batcher.shutdown()
        server.shutdown()
        server.server_close()
    assert got == card.predict(body) and len(got["detection_scores"]) > 0
    u8 = torch.from_numpy(preprocess_batch([decode_image(body)] * 4, 128)[0]).to(dev)
    pred = card.detector.predecode(u8).float()
    for x, y in zip(card.detector.nms(pred), card.detector.nms(pred.cpu())):
        assert torch.equal(x.cpu(), y)


# --- the jpeg -> boxes input paths: packed I420, the fused decode, the device
# letterbox, reference_demo ---------------------------------------------------

_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_codec_fixtures")


def test_native_decodes_equal_the_stored_oracles():
    """The fused JPEG -> I420 decode and the reduced RGB decode on this
    machine against the JAX package's and cv2's outputs stored with the
    corpus (sha256): host code, but built here by this machine's compiler."""
    import hashlib
    import json

    from fastvision_tpu_torch.data import codec

    _cuda()
    with open(os.path.join(_FIXTURES, "native_oracles.json")) as f:
        oracles = json.load(f)

    def read(name):
        with open(os.path.join(_FIXTURES, name), "rb") as f:
            return f.read()

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    for e in oracles["fused_i420"]:
        packed, scale, pads, orig, dec = codec.decode_jpeg_i420(
            read(e["file"]), e["size"], oracles["i420_pad_value"], e["reduce_target"])
        assert (digest(packed), float(np.float32(scale)), list(pads), list(orig), list(dec)) == (
            e["sha256"], e["scale"], e["pads"], e["orig_hw"], e["decoded_hw"]), e
    for e in oracles["fused_i420_raises"]:  # lossless: refused, as the JAX package refuses it
        with pytest.raises(ValueError):
            codec.decode_jpeg_i420(read(e["file"]), e["size"], oracles["i420_pad_value"],
                                   e["reduce_target"])
    for e in oracles["cv2_reduced"]:
        rgb = codec.decode_jpeg_reduced(read(e["file"]), e["factor"])
        assert [list(rgb.shape), digest(rgb)] == [e["shape"], e["sha256"]], e


def test_i420_and_letterbox_on_card_equal_cpu():
    """i420_packed_to_rgb and letterbox_batch on the card vs the CPU (float32,
    TF32 off inside letterbox_batch): 1e-3 on the 0-255 scale."""
    from fastvision_tpu_torch.ops.image import (
        i420_packed_to_rgb,
        letterbox_batch,
        pack_canvas,
        rgb_batch_to_i420_packed,
    )

    dev = _cuda()
    rng = np.random.default_rng(0)
    packed = torch.from_numpy(rgb_batch_to_i420_packed(
        rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)))
    card = i420_packed_to_rgb(packed.to(dev)).cpu()
    assert (card - i420_packed_to_rgb(packed)).abs().max() <= 1e-3
    arrs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((480, 640), (375, 500), (640, 427), (100, 90))]
    canvas, sizes = (torch.from_numpy(a) for a in pack_canvas(arrs, 640, 640))
    on_card = letterbox_batch(canvas.to(dev), sizes.to(dev), 416)
    on_cpu = letterbox_batch(canvas, sizes, 416)
    assert (on_card[0].cpu() - on_cpu[0]).abs().max() <= 1e-3
    for a, b in zip(on_card[1:], on_cpu[1:]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("mode", ["i420", "device_letterbox", "reference_demo", "tta"])
def test_input_paths_on_card_equal_cpu(mode):
    """A shallow YOLOv3's Detector in float32 (TF32 off) on each input path:
    the model's raw heads on the card against the CPU's from the same input
    (max|d| / std <= 1e-3), and the kernel's Detections on the card equal
    to the plain version's on the CPU from the same device predictions."""
    from fastvision_tpu_torch.data import normalize_images
    from fastvision_tpu_torch.infer import preprocess_batch
    from fastvision_tpu_torch.infer.postprocess import reference_demo_unscale
    from fastvision_tpu_torch.ops.image import letterbox_batch, pack_canvas, rgb_batch_to_i420_packed

    dev = _cuda()
    model = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(0))
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy() / 4
    card = Detector(model, anchors, input_size=128, batch_size=4, conf_thres=0.01,
                    dtype=torch.float32, device=dev)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((128, 96), (100, 128), (64, 64), (128, 128))]
    u8, metas = preprocess_batch(imgs, 128, pad_value=0 if mode == "reference_demo" else 114)
    x = torch.from_numpy(rgb_batch_to_i420_packed(u8) if mode == "i420" else u8)
    if mode == "device_letterbox":
        canvas, sizes = (torch.from_numpy(a) for a in pack_canvas(imgs, 160, 160))
        x = letterbox_batch(canvas, sizes, 128)[0]
        assert (letterbox_batch(canvas.to(dev), sizes.to(dev), 128)[0].cpu() - x).abs().max() <= 1e-3
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            xn = normalize_images(x, torch.float32)
            if mode == "tta":
                xn = torch.cat([xn, xn.flip(2)])
            heads_card = [h.cpu() for h in card.model(xn.to(dev))]
            model_cpu = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
                               generator=torch.Generator().manual_seed(0)).eval()
            heads_cpu = model_cpu(xn)
        pred = card.predecode_tta(x.to(dev)) if mode == "tta" else card.predecode(x.to(dev))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for a, b in zip(heads_card, heads_cpu):
        assert float((a - b).abs().max() / b.std()) <= 1e-3
    kw = dict(conf_thres=card.conf_thres, iou_thres=card.iou_thres, max_det=card.max_det,
              class_offset=card.class_offset)
    if mode == "reference_demo":
        ratios = torch.tensor([m["scale"] for m in metas], dtype=torch.float32, device=dev)
        pads = torch.tensor([m["pad"] for m in metas], dtype=torch.float32, device=dev)
        ori = torch.tensor([m["orig_hw"][::-1] for m in metas], dtype=torch.float32, device=dev)
        pred = reference_demo_unscale(pred.float(), ratios, pads[:, 0], pads[:, 1], ori[:, 0],
                                      ori[:, 1])
        kw.update(box_format="xyxy", score_mode="obj")
    launches = suppression_mask_cuda.launches
    on_card = batched_non_max_suppression(pred.float(), **kw)
    assert suppression_mask_cuda.launches > launches
    on_cpu = batched_non_max_suppression(pred.float().cpu(), **kw)
    assert int(on_cpu.valid.sum()) > 0
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("case", INT8_CONV_CASES, ids=[c[0] for c in INT8_CONV_CASES])
def test_int8_conv_card_route_equals_plain(case):
    """The card route's int32 accumulators bit-equal to the plain version's
    (float64 conv) on the card and on the CPU, from channels_last input."""
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    _, _, _, _, _, n, k, stride, groups = case
    x, w = (torch.from_numpy(a) for a in int8_conv_case(case))
    xd = x.to(dev).contiguous(memory_format=torch.channels_last)
    got = ti.int8_conv2d(xd, w.to(dev), stride, k // 2, groups)
    on_card = ti.int8_conv2d_plain(xd, w.to(dev), stride, k // 2, groups)
    torch.cuda.synchronize()
    want = ti.int8_conv2d_plain(x, w, stride, k // 2, groups)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got.cpu(), want) and torch.equal(on_card.cpu(), want)
    with pytest.raises(TypeError, match="int8"):
        ti.int8_conv2d(xd.float(), w.to(dev), stride, k // 2, groups)
    # the patches kernel on a float input against its plain version: bit-equal
    g = torch.Generator().manual_seed(len(case[0]))
    for dtype in (torch.float32, torch.bfloat16):
        xf = (torch.randn(x.permute(0, 2, 3, 1).shape, generator=g) * 3).to(dtype).to(dev)
        s = torch.tensor(0.0217, device=dev)
        k_pad = ti.gemm_weight(w, groups).shape[1]
        before = ti.quantize_patches_cuda.launches
        got = ti.quantize_patches(xf, s, k, stride, k // 2, k_pad)
        assert ti.quantize_patches_cuda.launches == before + 1
        assert torch.equal(got, ti.quantize_patches_plain(xf, s, k, stride, k // 2, k_pad))


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu", "silu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_epilogue_kernel_equals_plain(act, dtype):
    """The epilogue kernel against its plain version: equal, but for silu's
    expf, whose last bit may differ from PyTorch's build (<= 1 ulp of the
    output type)."""
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    g = torch.Generator().manual_seed(3)
    for m, n, n_pad in ((17, 12, 16), (4099, 64, 64), (1000, 1000, 1000)):
        acc = torch.randint(-2 ** 26, 2 ** 26, (m, n_pad), generator=g, dtype=torch.int32).to(dev)
        scale = (torch.rand(n, generator=g) * 1e-6).to(dev)
        bias = torch.randn(n, generator=g).to(dev)
        before = ti.epilogue_cuda.launches
        got = ti.epilogue(acc, n, scale, bias, act, dtype)
        assert ti.epilogue_cuda.launches == before + 1
        want = ti.epilogue_plain(acc, n, scale, bias, act, dtype)
        assert got.dtype == dtype and got.shape == (m, n)
        if act == "silu":
            ulp = torch.finfo(dtype).eps * want.float().abs().clamp_min(torch.finfo(dtype).tiny)
            assert float(((got.float() - want.float()).abs() / ulp).max()) <= 1.0
        else:
            assert torch.equal(got, want)


def test_int8_kernel_wrappers_reject_what_they_do_not_take():
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    x = torch.zeros(1, 8, 8, 16, device=dev)
    s = torch.tensor(1.0, device=dev)
    with pytest.raises(TypeError):
        ti.quantize_patches_cuda(x.half(), s, 3, 1, 1, 144)
    with pytest.raises(ValueError, match="contiguous"):
        ti.quantize_patches_cuda(x.permute(0, 2, 1, 3), s, 3, 1, 1, 144)
    with pytest.raises(ValueError, match="k_pad"):
        ti.quantize_patches_cuda(x, s, 3, 1, 1, 128)
    with pytest.raises(ValueError, match="in_scale"):
        ti.quantize_patches_cuda(x.to(torch.int8), s, 3, 1, 1, 144)
    acc = torch.zeros(20, 16, dtype=torch.int32, device=dev)
    scale = torch.ones(16, device=dev)
    with pytest.raises(TypeError):
        ti.epilogue_cuda(acc, 16, scale, scale, "silu", torch.float16)
    with pytest.raises(ValueError):
        ti.epilogue_cuda(acc.float(), 16, scale, scale, "silu", torch.float32)
    with pytest.raises(ValueError, match="activation"):
        ti.epilogue_cuda(acc, 16, scale, scale, "gelu", torch.float32)


INT8_ACTS = ("none", "relu", "leaky_relu", "silu")


@pytest.mark.parametrize("case", INT8_IMPLICIT_CASES, ids=[c[0] for c in INT8_IMPLICIT_CASES])
def test_int8_conv_kernel_equals_plain_and_the_gemm_route(case):
    """The implicit-GEMM kernel: mode (b) bit-equal to the plain version
    (float64 conv), mode (a) byte-equal to the patches + ``_int_mm`` +
    epilogue route in every activation and both output types (the same
    arithmetic, int8_common.cuh's, on the same exact sums)."""
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    _, _, _, _, _, n, k, stride, _ = case
    x, w = (torch.from_numpy(a) for a in int8_conv_case(case))
    xq = x.permute(0, 2, 3, 1).contiguous().to(dev)
    mat = ti.gemm_weight(w).to(dev)
    before = ti.int8_conv_cuda.launches
    acc, none = ti.int8_conv_cuda(xq, mat, n, k, stride)
    assert ti.int8_conv_cuda.launches == before + 1 and none is None
    want, _ = ti.int8_conv_plain(xq.cpu(), mat.cpu(), n, k, stride)
    assert acc.dtype == torch.int32 and torch.equal(acc.cpu(), want)
    assert torch.equal(ti.int8_conv2d(x.to(dev), w.to(dev), stride, k // 2).cpu(),
                       ti.int8_conv2d_plain(x, w, stride, k // 2))
    if case[0] == "saturated":
        assert int(want.max()) == -int(want.min()) == 127 ** 2 * 9 * 1024
    g = torch.Generator().manual_seed(n)
    scale = (torch.rand(n, generator=g) * 2e-5 + 1e-6).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    acc10 = ti.int8_gemm(ti.quantize_patches_cuda(xq, None, k, stride, k // 2, mat.shape[1]), mat)
    for dtype in (torch.float32, torch.bfloat16):
        for act in INT8_ACTS:
            got, _ = ti.int8_conv_cuda(xq, mat, n, k, stride, scale, bias, act, dtype)
            ref = ti.epilogue_cuda(acc10, n, scale, bias, act, dtype)
            assert got.dtype == dtype and torch.equal(got, ref), (dtype, act)


@pytest.mark.parametrize("case", INT8_IMPLICIT_CASES, ids=[c[0] for c in INT8_IMPLICIT_CASES])
def test_int8_conv_fused_epilogue_equals_the_composed_route(case):
    """The kernel with the residual add and its consumer's quantize in its
    epilogue, every combination (int8 only, int8 and float, each with a
    residual and without), byte-equal to mode (a) + PyTorch's add +
    `quantize_activation_cuda`, in both output types, and on the CPU
    `int8_conv_plain` gives the same bytes."""
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    _, _, _, _, _, n, k, stride, _ = case
    x, w = (torch.from_numpy(a) for a in int8_conv_case(case))
    xq = x.permute(0, 2, 3, 1).contiguous().to(dev)
    mat = ti.gemm_weight(w).to(dev)
    g = torch.Generator().manual_seed(n + 1)
    scale = (torch.rand(n, generator=g) * 2e-5 + 1e-6).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        y, _ = ti.int8_conv_cuda(xq, mat, n, k, stride, scale, bias, "silu", dtype)
        spread = float(y.float().std())
        res = (torch.randn(y.shape, generator=g) * spread).to(dev, dtype)
        out_scale = torch.tensor(spread / 40, device=dev)
        total = res + y

        def quantized(t):
            return ti.quantize_activation_cuda(t.view(1, t.shape[0], 1, n), out_scale).view(t.shape)

        for r, keep in ((None, False), (None, True), (res, False), (res, True)):
            before = ti.int8_conv_cuda.launches
            got, q = ti.int8_conv_cuda(xq, mat, n, k, stride, scale, bias, "silu", dtype, r,
                                       out_scale, keep)
            assert ti.int8_conv_cuda.launches == before + 1
            want = y if r is None else total
            assert q.dtype == torch.int8 and torch.equal(q, quantized(want)), (dtype, keep)
            assert (got is None) if not keep else torch.equal(got, want), (dtype, keep)
            assert int((q.abs() == 127).sum()) < q.numel() // 4  # not saturated throughout
            p_y, p_q = ti.int8_conv_plain(xq.cpu(), mat.cpu(), n, k, stride, scale.cpu(),
                                          bias.cpu(), "silu", dtype,
                                          None if r is None else r.cpu(), out_scale.cpu(), keep)
            assert torch.equal(p_q, q.cpu()) and (p_y is None) == (got is None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_quantize_pass_and_quantized_conv_on_the_implicit_gemm(dtype):
    """`quantize_activation_cuda` bit-equal to `quantize_activation`;
    `quantized_conv` of an eligible conv takes the quantize pass and the
    implicit GEMM (one launch each, no ``_int_mm``) and gives the bytes of
    the patches + ``_int_mm`` + epilogue route."""
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(2, 64, 17, 15, generator=g) * 3).to(dtype).to(dev)
    x = x.contiguous(memory_format=torch.channels_last)
    s = torch.tensor(0.0217, device=dev)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    xq = ti.quantize_activation_cuda(nhwc, s)
    assert torch.equal(xq, ti.quantize_activation(nhwc, s))
    w_q = torch.randint(-127, 128, (96, 64, 3, 3), generator=g, dtype=torch.int8).to(dev)
    mat = ti.gemm_weight(w_q)
    scale = (torch.rand(96, generator=g) * 1e-4).to(dev)
    bias = torch.randn(96, generator=g).to(dev)
    before = (ti.quantize_activation_cuda.launches, ti.int8_conv_cuda.launches,
              ti.quantize_patches_cuda.launches)
    y, q = ti.quantized_conv(x, s, w_q, mat, scale, bias, 2, 1, 1, "silu", dtype)
    assert q is None
    assert (ti.quantize_activation_cuda.launches, ti.int8_conv_cuda.launches,
            ti.quantize_patches_cuda.launches) == (before[0] + 1, before[1] + 1, before[2])
    acc = ti.int8_gemm(ti.quantize_patches_cuda(nhwc, s, 3, 2, 1, mat.shape[1]), mat)
    ref = ti.epilogue_cuda(acc, 96, scale, bias, "silu", dtype)
    assert y.shape == (2, 96, 9, 8) and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y.permute(0, 2, 3, 1).reshape(-1, 96), ref)


def test_int8_conv_wrapper_refuses_what_the_kernel_does_not_take():
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    xq = torch.zeros(1, 8, 8, 64, dtype=torch.int8, device=dev)
    mat = torch.zeros(32, 9 * 64, dtype=torch.int8, device=dev)
    one = torch.ones(32, device=dev)
    before = ti.int8_conv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ti.int8_conv_cuda(xq.cpu(), mat.cpu(), 32, 3, 1)
    with pytest.raises(TypeError, match="int8"):
        ti.int8_conv_cuda(xq.float(), mat, 32, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ti.int8_conv_cuda(xq.permute(0, 2, 1, 3), mat, 32, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):  # 16-byte aligned
        ti.int8_conv_cuda(torch.zeros(8 * 8 * 64 + 1, dtype=torch.int8, device=dev)[1:].view(
            1, 8, 8, 64), mat, 32, 3, 1)
    with pytest.raises(ValueError, match="does not take"):
        ti.int8_conv_cuda(xq[..., :48].contiguous(), mat[:, :9 * 48].contiguous(), 32, 3, 1)
    with pytest.raises(ValueError, match="does not take"):
        ti.int8_conv_cuda(xq, mat, 32, 5, 1)
    with pytest.raises(ValueError, match="w_mat"):
        ti.int8_conv_cuda(xq, mat[:, :64].contiguous(), 32, 3, 1)
    with pytest.raises(ValueError, match="together"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, scale=one)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "relu", torch.float16)
    with pytest.raises(ValueError, match="activation"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "gelu", torch.float32)
    res = torch.zeros(64, 32, dtype=torch.bfloat16, device=dev)
    s = torch.tensor(0.5, device=dev)
    with pytest.raises(ValueError, match="mode \\(a\\)"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, residual=res)
    with pytest.raises(ValueError, match="residual"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "relu", torch.float32, res)
    with pytest.raises(ValueError, match="residual"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "relu", torch.bfloat16, res.cpu())
    with pytest.raises(ValueError, match="out_scale"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "relu", torch.bfloat16, None, s.cpu())
    with pytest.raises(ValueError, match="keep_float"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "relu", torch.bfloat16, keep_float=False)
    assert ti.int8_conv_cuda.launches == before
    with pytest.raises(ValueError, match="multiple of 8"):
        ti.quantize_patches_cuda(torch.zeros(1, 8, 8, 3, device=dev), s, 3, 1, 1, 28)
    with pytest.raises(ValueError, match="CUDA"):
        ti.quantize_activation_cuda(torch.zeros(1, 4, 4, 8), torch.tensor(1.0))
    with pytest.raises(ValueError, match="C % 8"):
        ti.quantize_activation_cuda(torch.zeros(1, 4, 4, 3, device=dev),
                                    torch.tensor(1.0, device=dev))


def test_quantized_detector_on_card_equals_cpu_and_runs_int8_gemms():
    """A shallow YOLOv3 quantized by Detector.quantize on the card: float32
    heads card vs CPU (plain int8 route) within 1e-2 of their std (the int32
    sums are exact on both; a float rounding that differs flips an int8
    step); the forward runs 35 of its 36 int8 convs on the implicit GEMM
    (``int8_conv``), 30 of them writing their consumer's int8 input (5
    quantize passes, Darknet's residual adds in the epilogue), and the RGB
    stem on ``_int_mm``, and only the 3 float pred convs; the linked bf16
    heads equal the unlinked ones; the NMS kernel still runs."""
    from torch.profiler import ProfilerActivity, profile

    from fastvision_tpu_torch.infer.quantize import link_int8, quant_state
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(11))
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    det = Detector(model, anchors, input_size=96, batch_size=4, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, hw + (3,)).astype(np.uint8)
            for hw in ((96, 96), (120, 80), (50, 96), (200, 300))]
    det.quantize(imgs)
    assert len(quant_state(det.model)) == 36
    assert all(t.device.type == "cuda" for q in quant_state(det.model).values()
               for t in q.values())
    before = suppression_mask_cuda.launches
    out = det.predict_batch(imgs)
    assert suppression_mask_cuda.launches == before + 1 and all(
        np.isfinite(r["boxes"]).all() for r in out)
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(3))
    cpu_model = copy.deepcopy(det.model).cpu()
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            on_card = [h.cpu() for h in det.model(x.to(dev))]
            on_cpu = cpu_model(x)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for a, b in zip(on_card, on_cpu):
        assert float((a - b).abs().max() / b.std()) <= 1e-2
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        det.model(x.to(dev))
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("aten::_int_mm", 0) == 1  # the RGB stem (C = 3)
    assert counts.get("aten::convolution", 0) == 3  # the float pred convs alone
    kernels = (ti.int8_conv_cuda, ti.quantize_activation_cuda, ti.quantize_patches_cuda,
               ti.epilogue_cuda)
    before = [f.launches for f in kernels] + [ti.add_residual.runs]
    with torch.inference_mode():
        det.model(x.to(dev))
    # 30 convs write their consumer's int8 input: 5 quantize passes, no residual add
    assert [f.launches - b for f, b in zip(kernels, before)] == [35, 5, 1, 1]
    assert ti.add_residual.runs == before[-1]
    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
        linked = det.model(x.to(dev))
        link_int8(det.model, enabled=False)
        unlinked = det.model(x.to(dev))
        link_int8(det.model)
    assert all(torch.equal(a, b) for a, b in zip(linked, unlinked))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_quantize_kernels_round_as_the_division_at_half_integers(dtype):
    """The kernels' quantize (csrc/int8_common.cuh: a product with the
    reciprocal, the division near a half-integer) byte-equal to
    `quantize_activation` on values at and around the half-integer
    multiples of 24 scales: in the quantize pass and in `int8_conv`'s fused
    epilogue (a 1x1 conv whose weight copies its input, scale 1, bias 0)."""
    from fastvision_tpu_torch.ops import int8 as ti
    from fastvision_tpu_torch.testing import quantize_tie_cases

    dev = _cuda()
    values, scales = quantize_tie_cases()
    eye = torch.eye(32, dtype=torch.int8, device=dev)
    one, zero = torch.ones(32, device=dev), torch.zeros(32, device=dev)
    for row, sc in zip(torch.from_numpy(values), torch.from_numpy(scales)):
        s = sc.to(dev)
        v = row.to(dev, dtype).view(1, 1, -1, 8)
        assert torch.equal(ti.quantize_activation_cuda(v, s), ti.quantize_activation(v, s))
        # the fused epilogue's quantize: y = the residual, the conv's own output 0
        res = row[:row.numel() // 32 * 32].to(dev, dtype).view(-1, 32)
        xq = torch.zeros(1, res.shape[0], 1, 32, dtype=torch.int8, device=dev)
        _, q = ti.int8_conv_cuda(xq, eye, 32, 1, 1, one, zero, "none", dtype, res, s, False)
        assert torch.equal(q, ti.quantize_activation(res, s))


@pytest.mark.parametrize("name,shape,k,stride,k_pad,dtype", [
    ("yolov3_vgg16_stem", (3, 61, 67, 3), 3, 1, 32, torch.bfloat16),
    ("yolov3_stem_f32", (2, 45, 38, 3), 3, 1, 32, torch.float32),
    ("resnet50_stem", (2, 59, 63, 3), 7, 2, 152, torch.bfloat16),
    ("wide_line_tiled", (1, 5, 6001, 3), 3, 1, 32, torch.bfloat16),
    ("c5_k_pad_past_k", (2, 17, 19, 5), 3, 2, 56, torch.float32),
    ("c12_7x7", (1, 23, 29, 12), 7, 1, 592, torch.bfloat16),
    ("int8_input", (2, 33, 35, 3), 3, 1, 32, torch.int8),
    ("c100_rows_wider_than_the_block", (1, 9, 10, 100), 7, 1, 4904, torch.float32),
    ("f32_ends_mid_chunk", (1, 5, 7, 3), 3, 1, 32, torch.float32),
    ("bf16_ends_mid_chunk", (1, 5, 7, 3), 3, 1, 32, torch.bfloat16),
])
def test_patches_line_kernel_equals_plain(name, shape, k, stride, k_pad, dtype):
    """The line kernel (the shapes the implicit GEMM refuses: an RGB stem, C
    not a multiple of 8, K_pad past K) byte-equal to its plain version: the
    stems of YOLOv3 / VGG16 (3 x 3) and ResNet-50 (7 x 7 stride 2, K_pad 152:
    8-byte units), a line wider than the shared memory holds (tiles of
    columns), rows of more units than the block has threads, odd H and W,
    float32, bfloat16 and int8 inputs, inputs whose size is no multiple of
    16 bytes (x's last 16-byte chunk, cut short by its end, is read element
    by element: no load reaches past x)."""
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    g = torch.Generator().manual_seed(len(name))
    if dtype == torch.int8:
        x, s = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev), None
    else:
        x = (torch.randn(shape, generator=g) * 2).to(dev, dtype)
        s = torch.tensor(0.019, device=dev)
    if name.endswith("ends_mid_chunk"):
        assert x.numel() * x.element_size() % 16 and x.data_ptr() % 16 == 0
    before = ti.quantize_patches_cuda.launches
    got = ti.quantize_patches_cuda(x, s, k, stride, k // 2, k_pad)
    assert ti.quantize_patches_cuda.launches == before + 1
    want = ti.quantize_patches_plain(x, s, k, stride, k // 2, k_pad)
    assert got.shape == want.shape and torch.equal(got, want)
    assert int((want != 0).sum()) > want.numel() // 4


def _opcheck_cases(op: str, dev: torch.device) -> list[tuple]:
    """Seeded argument tuples of a ``fastvision::`` custom op on the card:
    the NMS kernel on `nms_case`s, the patches kernel (quantize pass, float
    and int8 patches, an RGB stem) and the epilogue on `INT8_CONV_CASES`,
    ``int8_conv`` in every mode on `INT8_IMPLICIT_CASES`."""
    from fastvision_tpu_torch.ops import int8 as ti

    g = torch.Generator().manual_seed(len(op))
    s = torch.tensor(0.0217, device=dev)
    cases = []
    if op == "nms_suppression_mask":
        for seed, (b, k) in enumerate(((1, 37), (8, 1024), (2, 2049))):
            boxes, scores = nms_case(seed, b, k, clusters=None if seed else 20)
            cases.append((torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev), 0.45))
    for case in INT8_CONV_CASES[:6] if op in ("int8_patches", "int8_epilogue") else ():
        _, _, _, _, _, n, k, stride, groups = case
        x, w = (torch.from_numpy(a) for a in int8_conv_case(case))
        xq = x.permute(0, 2, 3, 1).contiguous().to(dev)
        xf = (torch.randn(xq.shape, generator=g) * 3).to(dev)
        k_pad = ti.gemm_weight(w, groups).shape[1]
        if op == "int8_patches":
            cases += [(xf, s, k, stride, k // 2, k_pad, False),
                      (xq, None, k, stride, k // 2, k_pad, False)]
            if xf.shape[3] % 8 == 0:
                cases.append((xf.to(torch.bfloat16), s, 1, 1, 0, xf.shape[3], True))
        else:
            m, n_pad = xq.shape[0] * xq.shape[1] * xq.shape[2], -(-n // 8) * 8
            acc = torch.randint(-2 ** 26, 2 ** 26, (m, n_pad), generator=g,
                                dtype=torch.int32).to(dev)
            scale, bias = (torch.rand(n, generator=g) * 1e-6).to(dev), torch.randn(n).to(dev)
            cases.append((acc, n, scale, bias, ("silu", "leaky_relu")[len(cases) % 2],
                          (torch.bfloat16, torch.float32)[len(cases) % 2]))
    for case in INT8_IMPLICIT_CASES[:4] if op == "int8_conv" else ():
        _, _, _, _, _, n, k, stride, _ = case
        x, w = (torch.from_numpy(a) for a in int8_conv_case(case))
        xq = x.permute(0, 2, 3, 1).contiguous().to(dev)
        mat = ti.gemm_weight(w).to(dev)
        ho, wo = ti.out_hw(xq.shape[1], xq.shape[2], k, stride, k // 2)
        m = xq.shape[0] * ho * wo
        scale = (torch.rand(n, generator=g) * 2e-5 + 1e-6).to(dev)
        bias = torch.randn(n, generator=g).to(dev)
        res = torch.randn(m, n, generator=g).to(dev, torch.bfloat16)
        half = torch.tensor(0.05, device=dev)
        cases += [(xq, mat, n, k, stride, None, None, "none", torch.bfloat16, None, None, True),
                  (xq, mat, n, k, stride, scale, bias, "silu", torch.float32, None, None, True),
                  (xq, mat, n, k, stride, scale, bias, "silu", torch.bfloat16, res, half, True),
                  (xq, mat, n, k, stride, scale, bias, "leaky_relu", torch.bfloat16, None, half,
                   False)]
    return cases


@pytest.mark.parametrize("op", ["nms_suppression_mask", "int8_patches", "int8_epilogue",
                                "int8_conv"])
def test_custom_op_opcheck(op):
    """``torch.library.opcheck`` on each ``fastvision::`` op over seeded
    cases: its schema, its fake against the kernel's outputs, and its
    dispatch under tracing."""
    import fastvision_tpu_torch.ops.int8  # noqa: F401 (registers the int8 ops)

    dev = _cuda()
    cases = _opcheck_cases(op, dev)
    assert cases
    for args in cases:
        torch.library.opcheck(getattr(torch.ops.fastvision, op).default, args)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_exported_detector_on_card_runs_the_kernels_and_equals_eager(tmp_path, int8):
    """A shallow YOLOv3's Detector program exported on the card: one
    ``fastvision::nms_suppression_mask`` node (no unrolled loop), and with
    ``Detector.quantize`` first the int8 kernels' nodes (35 ``int8_conv``, 5
    quantize passes and the stem's patches, 1 epilogue); the loaded program
    bit-equal to eager ``Detector.infer``, its launches counted."""
    from fastvision_tpu_torch.infer import (detector_program, export_program, load_exported,
                                            op_counts)
    from fastvision_tpu_torch.ops import int8 as ti

    dev = _cuda()
    model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1),
                   generator=torch.Generator().manual_seed(12))
    anchors = COCO_ANCHORS.reshape(3, 3, 2)[::-1].copy()
    det = Detector(model, anchors, input_size=96, batch_size=4, device=dev, conf_thres=0.01)
    rng = np.random.default_rng(12)
    u8 = torch.from_numpy(rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)).to(dev)
    if int8:
        det.quantize(list(u8.cpu().numpy()))
    path = export_program(detector_program(det), [torch.zeros_like(u8)], str(tmp_path / "d.pt2"))
    program = load_exported(path)
    counts = op_counts(program)
    assert counts["fastvision.nms_suppression_mask.default"] == 1
    assert counts["aten.select.int"] < 100  # the greedy loop is the kernel's, not unrolled
    want_int8 = {"fastvision.int8_conv.default": 35, "fastvision.int8_patches.default": 6,
                 "fastvision.int8_epilogue.default": 1} if int8 else {}
    assert {k: v for k, v in counts.items() if "int8" in k} == want_int8
    kernels = (suppression_mask_cuda, ti.int8_conv_cuda, ti.quantize_activation_cuda,
               ti.quantize_patches_cuda, ti.epilogue_cuda)
    before = [f.launches for f in kernels]
    got = program.module()(u8)
    launched = [f.launches - b for f, b in zip(kernels, before)]
    assert launched == ([1, 35, 5, 1, 1] if int8 else [1, 0, 0, 0, 0])
    want = det.infer(u8)._asdict()
    assert want["valid"].any()
    for k, t in want.items():
        assert torch.equal(got[k], t), k


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_global_batchnorm_on_card_equals_cpu():
    """`GlobalBatchNorm` (forward and backward) on the card against the CPU,
    in a one-rank gloo group (gloo reduces CUDA and CPU tensors), float32:
    outputs and gradients within 1e-4 of their largest magnitude."""
    import torch.distributed as dist

    from fastvision_tpu_torch.nn.layers import GlobalBatchNorm

    dev = _cuda()
    if dist.is_initialized():
        pytest.skip("a process group exists already")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        g = np.random.default_rng(5)
        x, dy = g.normal(1, 2, (8, 32, 13, 13)), g.normal(0, 1, (8, 32, 13, 13))
        w, b = g.normal(1, 0.2, 32), g.normal(0, 0.2, 32)

        def run(device):
            xt = torch.tensor(x, dtype=torch.float32, device=device).to(
                memory_format=torch.channels_last).requires_grad_(True)
            wt = torch.tensor(w, dtype=torch.float32, device=device, requires_grad=True)
            bt = torch.tensor(b, dtype=torch.float32, device=device, requires_grad=True)
            y, mean, var = GlobalBatchNorm.apply(xt, wt, bt, 1e-5)
            y.backward(torch.tensor(dy, dtype=torch.float32, device=device))
            return [t.detach().cpu() for t in (y, mean, var, xt.grad, wt.grad, bt.grad)]

        for got, want in zip(run(dev), run("cpu")):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))
    finally:
        dist.destroy_process_group()


def test_world_size_1_over_nccl_equals_the_plain_step():
    """One float32 SGD step (TF32 off, cuDNN deterministic) of a shallow
    YOLOv3 at 256 px, batch 4, under ``Fit(mesh=...)`` in a one-rank NCCL
    group: DDP bit-equal to the plain ``Fit`` step, FSDP within 1e-5 of
    each tensor's std (momentum included)."""
    import torch.distributed as dist

    from fastvision_tpu_torch.core import create_mesh
    from fastvision_tpu_torch.parallel import full_state
    from fastvision_tpu_torch.train import Fit, build_optimizer, make_train_step

    dev = _cuda()
    if dist.is_initialized():
        pytest.skip("a process group exists already")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    _, loss_fn = _train_parts()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _one_batch(256).items()
             if k in ("images", "labels")}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    states = {}
    try:
        for kind in (None, "ddp", "fsdp"):
            model = YOLOv3(num_classes=80, stage_sizes=(1, 1, 1, 1, 1),
                           generator=torch.Generator().manual_seed(7))
            fit = Fit(model, loss_fn, build_optimizer("sgd", model, momentum=0.9), None,
                      mesh=create_mesh() if kind else None, fsdp=kind == "fsdp",
                      step_fn=make_train_step(loss_fn), device=dev)
            fit.state, _ = fit.step_fn(fit.state, batch, 1e-2)
            if kind == "fsdp":
                states[kind] = full_state(model, fit.state.optimizer)
            else:
                states[kind] = ({k: v.cpu() for k, v in model.state_dict().items()},
                                {i: s["momentum_buffer"].cpu() for i, s in
                                 fit.state.optimizer.state_dict()["state"].items()})
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags
        dist.destroy_process_group()
    plain, ddp = states[None], states["ddp"]
    for k, v in plain[0].items():
        assert torch.equal(ddp[0][k], v), k
    for i, v in plain[1].items():
        assert torch.equal(ddp[1][i], v), i
    fsdp_model, fsdp_opt = states["fsdp"]
    fsdp_mom = {i: s["momentum_buffer"] for i, s in fsdp_opt["state"].items()}
    for got, want in ((fsdp_model, plain[0]), (fsdp_mom, plain[1])):
        for k, w in want.items():
            if w.is_floating_point() and w.numel() > 1:
                d = float((got[k] - w).abs().max())
                assert d <= 1e-5 * max(float(w.std()), 1e-12), (k, d)


# --- every image and video read as the JAX package's cv2 calls read it -------

def _parity_digest(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_cv2_parity_images_equal_the_manifest_on_card():
    """The 32 committed cv2-parity files (tests/torch_codec_fixtures/
    cv2_parity) on this machine's host build: on the memory, file, reduced
    and fused routes the port's own decoders (JPEG, BMP, PNG) give the
    digests the JAX package's calls gave, and raise where those gave no
    image; the formats handed to cv2 equal this machine's cv2 calls."""
    import json

    from fastvision_tpu_torch.data import codec
    from fastvision_tpu_torch.data import dataset as tds

    _cuda()
    root = os.path.join(_FIXTURES, "cv2_parity")
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    for e in manifest["files"]:
        path = os.path.join(root, e["file"])
        with open(path, "rb") as f:
            data = f.read()
        routes = {"memory": lambda: codec.decode_image(data),
                  "file": lambda: tds.imread_rgb(path),
                  "reduced": lambda: tds.imread_rgb_scaled(path, manifest["reduce_target"])}
        for route, fn in routes.items():
            want = e["routes"][route]
            if want is None:
                with pytest.raises(ValueError):
                    fn()
                continue
            got = fn()
            img = got[0] if route == "reduced" else got
            if e["kind"] == "cv2":
                import cv2

                ref = (cv2.imread(path) if route != "memory"
                       else cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
                assert np.array_equal(img, ref[..., ::-1]), (e["file"], route)
                continue
            assert [list(img.shape), _parity_digest(img)] == [want["shape"], want["sha256"]], \
                (e["file"], route)
            if route == "reduced":
                assert list(got[1]) == want["orig"], e["file"]
        size = manifest["fused_size"]
        want = e["routes"]["fused"]
        if want is None:
            with pytest.raises(ValueError):
                codec.decode_jpeg_i420(data, size, 114, size)
            continue
        got = codec.decode_jpeg_i420(data, size, 114, size)
        if want == "fallback":
            assert got is None, e["file"]
            continue
        assert (_parity_digest(got[0]), got[1], list(got[2]), list(got[3]), list(got[4])) == (
            want["sha256"], want["scale"], want["pads"], want["orig"], want["decoded"]), e["file"]


def test_cv2_videos_read_as_videocapture_on_card():
    """The committed videos the port hands to cv2 (refused MPEG-4 files,
    H.264, Matroska, VP9): ``reader`` "cv2" and every frame equal to this
    machine's ``cv2.VideoCapture`` read loop."""
    import json

    import cv2

    from fastvision_tpu_torch.data import avi

    _cuda()
    root = os.path.join(os.path.dirname(_FIXTURES), "torch_video_fixtures", "cv2")
    with open(os.path.join(root, "manifest.json")) as f:
        videos = json.load(f)["videos"]
    for e in videos:
        path = os.path.join(root, e["file"])
        video = avi.open_video(path)
        assert video.reader == "cv2", e["file"]
        cap = cv2.VideoCapture(path)
        want = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            want.append(bgr[..., ::-1])
        got = list(video.frames())
        assert len(got) == len(want) > 0 and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_span_opens_under_emit_nvtx(monkeypatch):
    """`core.telemetry.span` opens its range under ``emit_nvtx`` (which makes
    it an NVTX range for ``nsys``), and under a profiler of the card alone."""
    from fastvision_tpu_torch.core import telemetry

    _cuda()
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    with torch.autograd.profiler.emit_nvtx():
        with telemetry.span("fit.step"):
            torch.ones(8, device="cuda").sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        with telemetry.span("data.wait"):
            torch.ones(8, device="cuda").sum()
    with telemetry.span("step.loss"):
        pass
    assert opened == ["fit.step", "data.wait"]
