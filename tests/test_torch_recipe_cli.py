"""The training recipe's options through the port's CLI on the CPU: the
YOLOv3 ``train`` with ``train.accum_steps: 2`` and every augmentation op
the detection loader takes, ``train-cls`` with the classification ops, and
the commands whose JAX counterparts ignore ``train.accum_steps`` refusing
a value > 1 (Faster R-CNN ``train``, ``train-cls``, ``train-video``).
Small models, 64 px, serial loaders."""
import os

import numpy as np
import pytest
import torch
import yaml

from fastvision_tpu_torch import cli
from fastvision_tpu_torch.testing import write_classification_dataset, write_detection_dataset
from fastvision_tpu_torch.train.optim import MultiSteps
from test_torch_cls_train import _small_zoo_model
from test_torch_eval_cli import C, SIZES, _small_yolo

torch.set_num_threads(2)
# every op but 'normalization' (whose float32 output the process pools refuse)
DETECTION_OPS = [
    "bgr2rgb:0.5", {"op": "jitter", "ratio": 0.3, "p": 0.5},
    {"op": "resize_by_max", "size": 96, "p": 0.5}, {"op": "padding", "size": 100, "p": 0.5},
    {"op": "random_crop", "size": 90, "p": 0.5}, {"op": "center_crop", "size": 80, "p": 0.5},
    {"op": "resize", "size": 72, "p": 0.5}, "hflip:0.5", "vflip:0.5", "hsv:0.5",
    "hist_equalize:0.5", {"op": "blur", "kind": "gaussian", "p": 0.5}, "channel_shuffle:0.5"]
CLS_OPS = [{"op": "random_crop", "size": 40}, {"op": "center_crop", "size": 36},
           {"op": "resize", "size": 32}, "hflip:0.5"]


def _config(tmp_path, augment, **train) -> str:
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"data": {"augment": augment}, "train": train}, f)
    return path


def test_cli_train_accumulates_over_two_batches_with_every_op(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    root = write_detection_dataset(str(tmp_path / "ds"), 8, sizes=SIZES, seed=3, num_classes=C)
    common = ["--config", _config(tmp_path, DETECTION_OPS, accum_steps=2),
              f"data.data_root={root}", "data.num_workers=0", "data.input_size=64",
              "data.batch_size=2", f"model.num_classes={C}", "data.max_boxes=8",
              "train.bf16=false", "train.epochs=1", f"train.ckpt_dir={tmp_path / 'ck'}",
              "--device", "cpu"]
    fit = cli.main(["train", *common])
    opt = fit.state.optimizer
    assert isinstance(opt, MultiSteps) and opt.every_k == 2
    assert fit.global_step == 4 and opt.mini_step == 0  # 4 calls: 2 updates
    aug = fit.train_loader.augmentation
    assert len(aug.ops) == len(DETECTION_OPS)
    lines = [yaml.safe_load(x) for x in open(os.path.join(tmp_path / "ck", "train.jsonl"))]
    assert np.isfinite([r["train_loss"] for r in lines if "train_loss" in r]).all()


def test_cli_train_cls_takes_the_classification_ops(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_build_zoo_model", _small_zoo_model)
    root = write_classification_dataset(str(tmp_path / "ds"), 8, num_classes=2,
                                        sizes=((48, 40), (36, 52)), seed=2)
    fit = cli.main(["train-cls", "--config", _config(tmp_path, CLS_OPS),
                    f"data.data_root={root}", "model.num_classes=2", "data.input_size=32",
                    "data.batch_size=4", "data.num_workers=0", "train.epochs=1",
                    f"train.ckpt_dir={tmp_path / 'ck'}", "--device", "cpu"])
    assert fit.global_step == 2
    assert [type(op).__name__ for op in fit.train_loader.augmentation.ops] == [
        "RandomCrop", "CenterCrop", "Resize", "HorizontalFlip"]


@pytest.mark.parametrize("command", [["train-cls"], ["train", "model.name=faster_rcnn"],
                                     ["train-video"]],
                         ids=["train-cls", "faster_rcnn", "train-video"])
def test_cli_refuses_accum_steps_where_jax_ignores_it(tmp_path, command):
    """The JAX package's train-cls, Faster R-CNN train and train-video never
    pass train.accum_steps to their optimizer: the port refuses a value > 1
    before building anything, rather than train otherwise."""
    with pytest.raises(SystemExit, match="train.accum_steps=4 accumulates gradients in the "
                                         "YOLOv3 train only"):
        cli.main([*command, "train.accum_steps=4", f"data.data_root={tmp_path}",
                  "--device", "cpu"])
