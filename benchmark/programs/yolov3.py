"""The port's YOLOv3 as its YOLOv3 recipe trains it: `YOLOv3Loss` (v5
decode) under ``make_train_step``."""
import numpy as np

from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.train import YOLOv3Loss, make_train_step


def model(cfg: dict):
    return YOLOv3(num_classes=cfg["num_classes"], channels=tuple(cfg["channels"]),
                  act=cfg["act"], stage_sizes=tuple(cfg["stage_sizes"]))


def step(cfg: dict, dtype):
    lc = cfg["loss"]
    loss_obj = YOLOv3Loss(np.asarray(cfg["anchors"], np.float32), tuple(cfg["strides"]),
                          cfg["num_classes"], ratio_box=lc["ratio_box"],
                          ratio_conf=lc["ratio_conf"], ratio_cls=lc["ratio_cls"],
                          ratio_thres=lc["ratio_thres"], decode_style=lc["decode"])

    def loss_fn(heads, batch):
        out = loss_obj(heads, batch["labels"])
        return out.total, {"box": out.box, "obj": out.obj, "cls": out.cls}

    return loss_fn, make_train_step(loss_fn, dtype)
