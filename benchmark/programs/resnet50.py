"""The port's ResNet-50 as its ``train-cls`` recipe trains it: softmax
cross-entropy under ``make_train_step`` with ImageNet standardization."""
from fastvision_tpu_torch.models.classification.resnet import Bottleneck, ResNet
from fastvision_tpu_torch.train import cross_entropy, make_train_step


def model(cfg: dict):
    return ResNet(Bottleneck, tuple(cfg["stage_sizes"]), num_classes=cfg["num_classes"])


def step(cfg: dict, dtype):
    def loss_fn(logits, batch):
        acc = (logits.argmax(dim=-1) == batch["labels"]).float().mean()
        return cross_entropy(logits.float(), batch["labels"]), {"acc": acc}

    return loss_fn, make_train_step(loss_fn, dtype, imagenet=True)
