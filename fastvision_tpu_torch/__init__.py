"""fastvision_tpu_torch: the PyTorch + CUDA port of fastvision_tpu.

The JAX package `fastvision_tpu` is the reference; this package mirrors its
file layout so each module has an obvious counterpart, and imports neither
JAX nor anything of the JAX package. Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Ported so far: the YOLOv3 `Detector` inference chain (letterbox ->
normalize -> Darknet-53 + YOLOv3 neck/head -> decode -> class-offset greedy
NMS -> unscale) and the YOLOv3 training path (`train.Fit` over
`data.DetectionLoader` with `train.YOLOv3Loss`, SGD / Adam, schedules, EMA
and `train.detection_evaluator`), and Faster R-CNN (VGG16 + RPN + RoI-align
head, `models.FasterRCNN`) for evaluation and training through `Fit`
(`train.make_frcnn_train_step`, `train.make_frcnn_eval_step`). Greedy NMS
suppression runs as a hand-written CUDA kernel (`csrc/nms.cu`) on CUDA
tensors and as its plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"
